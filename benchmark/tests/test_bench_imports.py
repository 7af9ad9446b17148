"""What the benchmark may load: no JAX, no JAX package, and a reference
that takes nothing of the program; and a run without a card prints no
result."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_names_compare_whole_top_level():
    saved = dict(sys.modules)
    try:
        sys.modules["vinsat_tpu_torch_fake.x"] = sys
        sys.modules["jaxfake"] = sys
        assert harness.forbidden_modules() == []
        sys.modules["vinsat_tpu.fake"] = sys
        sys.modules["jax"] = sys
        assert harness.forbidden_modules() == ["jax", "vinsat_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_reference_and_inputs_import_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.stream, benchmark.inputs.sim, "
            "benchmark.metrics.k1_work; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    tops = set(json.loads(out.strip().replace("'", '"')))
    assert not tops & {"vinsat_tpu_torch", "vinsat_tpu", "jax", "jaxlib",
                       "flax"}


def test_harness_sources_name_no_jax():
    for path in (ROOT / "benchmark").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                top = s.split()[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "vinsat_tpu"), \
                    (path, line)


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "bench_arc_sim.dataset", "--seed", str(2**33 + 1), "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    p = _run(ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_only_the_benchmark_files_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
