#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (vinsat_tpu_torch) on one NVIDIA
GPU: the quickest proof that the port still starts and is right there.

    python3 chip_smoke.py          # from the repository root

Phases (each prints its lines; any failure exits non-zero):
  1. device: the card's name and power limit;
  2. build: kernel K1 (kernels/csrc/tridiag_pcr.cu) compiled with nvcc;
  3. K1 against its plain PyTorch twin on the card (B=9 λ candidates,
     N in {5, 64, 257, 448}, Jacobi-scaled blocks): relative error
     <= 1e-9 in f64 (also against the Thomas solve) and <= 1e-4 in f32,
     and both times at N=448, B=9 in f64;
  4. the slice: streaming orbit determination of the committed 10800 s
     fixture (tests/data/torch_stream_seed1.npz) through the port's
     run_streaming on cuda in f64, once cold and twice timed, held to the
     JAX package's result in the fixture (window count, time to 5 km,
     final error within 0.01 km), with K1's launch count from that run;
  5. the tail refinement (refine_terminal, rigid chain) of the stream's
     final states over the whole arc on cuda — the bench arc ends on a
     detection knot, so the stream itself never runs it — against the JAX
     result in the fixture: relative 1e-6.
The last two lines are the kernels' JSON record and the device JSON line.
Needs torch with CUDA and nvcc; imports no JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_stream_seed1.npz")
K1_SOURCE = "vinsat_tpu_torch/kernels/csrc/tridiag_pcr.cu"
K1_REPLACES = "vinsat_tpu/kernels/tridiag_pallas.py:157"
DURATION_S = 10800


def _check(ok, what) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def _problem(rng, B, N, k=9):
    """Scaled SPD-dominant blocks spread over ~1e6, Jacobi-scaled as
    ba.jacobi_scaled_tridiag_solve hands them to K1."""
    import numpy as np

    A = rng.normal(size=(B, N, k, k)) * 0.1
    D = np.einsum("btij,btkj->btik", A, A) + np.eye(k) * 3.0
    U = rng.normal(size=(B, N - 1, k, k)) * 0.05
    b = rng.normal(size=(B, N, k))
    s = 10.0 ** rng.uniform(-3, 3, size=(B, N, k))
    D = D * s[..., :, None] * s[..., None, :]
    U = U * s[:, :-1, :, None] * s[:, 1:, None, :]
    b = b * s
    j = 1.0 / np.sqrt(np.diagonal(D, axis1=-2, axis2=-1))
    return (D * j[..., :, None] * j[..., None, :],
            U * j[:, :-1, :, None] * j[:, 1:, None, :], b * j)


def _time_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from vinsat_tpu_torch import pipeline
    from vinsat_tpu_torch.estimation import ba, ingest, refine, window
    from vinsat_tpu_torch.evalx import ate
    from vinsat_tpu_torch.kernels import _build, tridiag_pcr

    fx = np.load(FIXTURE)
    dev = torch.device("cuda")

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = _smi()
    print(f"device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    print(f"nvidia-smi: {smi}")

    # 2. build
    t0 = time.time()
    _build.load("tridiag_pcr")
    print(f"build: tridiag_pcr in {time.time() - t0:.2f} s")
    for line in _build.build_logs.get("tridiag_pcr", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. K1 against its plain twin (and Thomas) on the card
    solve = tridiag_pcr.block_tridiag_solve_pcr
    plain = tridiag_pcr.block_tridiag_solve_pcr_plain
    rng = np.random.default_rng(0)
    max_abs = 0.0
    for N in (5, 64, 257, 448):
        D, U, b = _problem(rng, 9, N)
        for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 1e-4)):
            Dc, Uc, bc = (torch.as_tensor(a, dtype=dtype, device=dev)
                          for a in (D, U, b))
            x = solve(Dc, Uc, bc)
            xp = plain(Dc, Uc, bc)
            torch.cuda.synchronize()
            err = float((x - xp).abs().max() / xp.abs().max())
            line = f"K1 N={N} B=9 {str(dtype)[6:]}: rel err vs plain {err:.3e}"
            if dtype == torch.float64:
                max_abs = max(max_abs, float((x - xp).abs().max()))
                xt = ba.block_tridiag_solve(Dc, Uc, bc)
                err_t = float((x - xt).abs().max() / xt.abs().max())
                line += f", vs Thomas {err_t:.3e}"
                _check(err_t <= tol, (N, err_t))
            print(line)
            _check(np.isfinite(err) and err <= tol, (N, dtype, err))
    D, U, b = (torch.as_tensor(a, device=dev)
               for a in _problem(rng, 9, 448))
    # alternate plain, kernel, kernel, plain on one card
    p1 = _time_ms(lambda: plain(D, U, b))
    k1 = _time_ms(lambda: solve(D, U, b))
    k2 = _time_ms(lambda: solve(D, U, b))
    p2 = _time_ms(lambda: plain(D, U, b))
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"K1 time N=448 B=9 f64: kernel {k_ms:.4f} ms ({k1:.4f}, "
          f"{k2:.4f}), plain {p_ms:.4f} ms ({p1:.4f}, {p2:.4f})  [{smi}]")

    # 4. the slice on the card
    seed = int(fx["seed"])
    cfg = window.StreamingConfig(dtype="float64")
    det, orbit = pipeline.stream_inputs(fx)
    prep = window.prepare_stream(det, orbit, seed, cfg, device=dev)
    n_windows = len(ingest.split_windows(prep.graph.ii, prep.knot_t))
    solve.launches = 0
    t0 = time.time()
    res = pipeline.run_streaming(fx, seed=seed, cfg=cfg, device=dev)
    cold = time.time() - t0
    launches = solve.launches
    walls = []
    for _ in range(2):
        t0 = time.time()
        res = pipeline.run_streaming(fx, seed=seed, cfg=cfg, device=dev)
        walls.append(time.time() - t0)
    t5 = ate.time_to_threshold(res.errors, res.times, 5.0)
    final = float(res.errors[-1])
    ref_final = float(fx["final_error_km"])
    print(f"stream: {n_windows} windows, {len(res.errors)} errors, "
          f"time_to_5km_s {t5} (JAX {float(fx['time_to_5km_s'])}), "
          f"final_error_km {final:.6f} (JAX {ref_final:.6f}), "
          f"recovery_trips {res.recovery_trips}")
    _check(np.isfinite(res.errors).all()
           and np.isfinite(res.final_states).all(), "finite results")
    _check(n_windows == int(fx["num_windows"]) == 7, n_windows)
    _check(t5 == float(fx["time_to_5km_s"]), t5)
    _check(abs(final - ref_final) <= 0.01, (final, ref_final))
    _check(len(res.errors) == len(fx["errors"]), len(res.errors))
    print(f"stream: max |d error| vs JAX {np.abs(res.errors - fx['errors']).max():.3e} km")
    _check(launches > 0, "K1 was not launched on the main path")
    print(f"stream: K1 launches {launches}")
    wall = min(walls)
    print(f"stream wall: cold {cold:.2f} s, timed {walls[0]:.2f} s / "
          f"{walls[1]:.2f} s -> {DURATION_S / wall:.1f} frames/s  [{smi}]")

    # 5. the tail refinement on the card
    N = len(res.final_states)
    t0 = time.time()
    refined = refine.refine_terminal(
        res.final_states, prep.gaps[:N], prep.gt.landmarks_xyz,
        prep.graph.uv, prep.graph.conf, prep.graph.ii, prep.intr_np,
        cum_rot=prep.cum_rot[:N], device=dev)
    t_ref = time.time() - t0
    ref = fx["refined_states"]
    err = float(np.abs(refined - ref).max() / np.abs(ref).max())
    print(f"refine_terminal: {N} knots, {len(prep.graph.ii)} observations, "
          f"{t_ref:.2f} s, rel err vs JAX {err:.3e}  [{smi}]")
    _check(np.isfinite(refined).all() and err <= 1e-6, err)

    print(json.dumps({"kernels": [{
        "name": "tridiag_pcr", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches,
        "max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
