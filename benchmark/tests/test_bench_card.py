"""Each cell once on the card, briefly and traced: the result line's keys,
`correct`, the trace's numbers.  Skips without a card; run on the card:

    python -m pytest --noconftest -o addopts="" -m cuda \\
        benchmark/tests/test_bench_card.py
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2**32 + 11), "--seconds", "2", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert out["metrics"] and out["breakdown"]["device_ops"]
    assert list(out)[-1] == "checks"
