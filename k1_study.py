#!/usr/bin/env python3
"""Kernel K1 (vinsat_tpu_torch/kernels/csrc/tridiag_pcr.cu) on one NVIDIA
GPU: where its time goes, and this checkout held against another one.

    python3 k1_study.py                # ablation of this checkout's K1
    python3 k1_study.py --against DIR  # then DIR's and this checkout's K1
                                       # and stream, in turns

Ablation.  The kernel is rebuilt with parts of its work cut out of the
source (text edits below, each of which must match), and every build is
timed at chip_smoke.py phase 3's shapes (B=9; N 64-1024 in f64, 448 in
f32): CUDA events over 20 calls and the device time of one call under
torch.profiler.  Only the times of the cut builds mean anything: their
answers are wrong.
  full     the kernel as it is;
  barrier  no row's work at all: the launch and the grid barriers;
  no_gj    no Gauss-Jordan pass: the update and the P traffic stay;
  no_nbr   no read of the neighbours' P through L2 (zeros instead).

Against DIR, a checkout of another commit (e.g. the parent, unpacked with
`git archive` into build/archive/parent, which git ignores): each checkout
runs in a process of its own, in the order DIR, this, this, DIR.  Each
prints K1's times as chip_smoke.py phase 3 does, then streams the
committed fixture (tests/data/torch_stream_seed1.npz) through its own
run_streaming on cuda in f64, once to warm up and twice timed (host
wall), with K1's launches and the result.

Needs a card, nvcc and torch; imports no JAX.
"""
from __future__ import annotations

import importlib.util
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "vinsat_tpu_torch" / "kernels" / "csrc" / "tridiag_pcr.cu"
# build name: [(text of the source, its replacement, occurrences)]
VARIANTS = {
    "full": [],
    "barrier": [("for (int g = warp; g < R; g += nwarps)",
                 "for (int g = warp; g < 0; g += nwarps)", 2)],
    "no_gj": [("gauss_jordan(a);", "", 2)],
    "no_nbr": [("vm_off >= 0 && i >= s", "false", 1),
               ("vp_off >= 0 && i + s < n", "false", 1)],
}
STREAM_RUNS = 2  # timed streams per process
# runs one checkout in a process whose working directory is that checkout,
# so that `import vinsat_tpu_torch` finds the checkout's package
WORKER = ("import importlib.util, sys; "
          "spec = importlib.util.spec_from_file_location('k1_study', "
          "sys.argv[1]); m = importlib.util.module_from_spec(spec); "
          "spec.loader.exec_module(m); m.run_checkout(sys.argv[2])")


def _chip_smoke():
    """This checkout's chip_smoke.py, loaded from its file (its helpers time
    K1 in every checkout alike)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ablate() -> None:
    """Every build of VARIANTS, built at once, then timed in turn."""
    import torch

    from vinsat_tpu_torch.kernels import _build, tridiag_pcr

    cs = _chip_smoke()
    smi = cs._smi()
    dev = torch.device("cuda")
    text = SOURCE.read_text()
    out = _build.BUILD_DIR / "k1_study"
    out.mkdir(parents=True, exist_ok=True)

    def build(name):
        src = text
        for old, new, n in VARIANTS[name]:
            if src.count(old) != n:
                raise RuntimeError(f"{name}: {old!r} found {src.count(old)} "
                                   f"times in {SOURCE}, not {n}")
            src = src.replace(old, new)
        path = out / f"tridiag_pcr_{name}.cu"
        path.write_text(src)
        return _build.load(f"tridiag_pcr_{name}", path)

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    full = _build._loaded.get("tridiag_pcr")
    try:
        for name, lib in libs.items():
            # the wrapper launches this build
            _build._loaded["tridiag_pcr"] = lib
            regs = [ln.strip() for ln in _build.build_logs.get(
                f"tridiag_pcr_{name}", "").splitlines() if "registers" in ln]
            print(f"== K1 build {name}: resident warps "
                  f"{tridiag_pcr.resident_warps(torch.float64)} in f64, "
                  f"{tridiag_pcr.resident_warps(torch.float32)} in f32; "
                  f"{' | '.join(regs)}")
            cs._k1_times(tridiag_pcr.block_tridiag_solve_pcr,
                         tridiag_pcr.block_tridiag_solve_pcr_plain, dev, smi)
    finally:
        if full is None:
            _build._loaded.pop("tridiag_pcr", None)
        else:
            _build._loaded["tridiag_pcr"] = full


def run_checkout(root: str) -> None:
    """K1's times and timed streams of the checkout whose package this
    process imports (the working directory's)."""
    import numpy as np
    import torch

    from vinsat_tpu_torch import pipeline
    from vinsat_tpu_torch.estimation import window
    from vinsat_tpu_torch.evalx import ate
    from vinsat_tpu_torch.kernels import tridiag_pcr

    cs = _chip_smoke()
    smi = cs._smi()
    dev = torch.device("cuda")
    solve = tridiag_pcr.block_tridiag_solve_pcr
    print(f"== checkout {root}: K1 of {Path(tridiag_pcr.__file__).parent}")
    cs._k1_times(solve, tridiag_pcr.block_tridiag_solve_pcr_plain, dev, smi)
    fx = np.load(Path(root) / "tests" / "data" / "torch_stream_seed1.npz")
    seed = int(fx["seed"])
    cfg = window.StreamingConfig(dtype="float64")
    t0 = time.time()
    pipeline.run_streaming(fx, seed=seed, cfg=cfg, device=dev)
    warm = time.time() - t0
    walls = []
    for _ in range(STREAM_RUNS):
        solve.launches = 0
        t0 = time.time()
        res = pipeline.run_streaming(fx, seed=seed, cfg=cfg, device=dev)
        walls.append(time.time() - t0)
    t5 = ate.time_to_threshold(res.errors, res.times, 5.0)
    print(f"stream of {root}: walls {' / '.join(f'{w:.2f}' for w in walls)} "
          f"s (warm-up run {warm:.2f} s), K1 launches {solve.launches} a "
          f"run, time_to_5km_s {t5}, final_error_km "
          f"{float(res.errors[-1]):.6f}  [{smi}]", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_study: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    if args and (len(args) != 2 or args[0] != "--against"):
        print(__doc__, file=sys.stderr)
        return 2
    ablate()
    if args:
        other = Path(args[1]).resolve()
        for root in (other, ROOT, ROOT, other):
            sys.stdout.flush()
            subprocess.run([sys.executable, "-c", WORKER, __file__,
                            str(root)], cwd=root, check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
