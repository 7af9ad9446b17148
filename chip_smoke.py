#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (vinsat_tpu_torch) on one NVIDIA
GPU: the quickest proof that the port still starts and is right there.

    python3 chip_smoke.py          # from the repository root

Phases (each prints its lines; any failure exits non-zero):
  1. device: the card's name and power limit;
  2. build: kernels K1 (kernels/csrc/tridiag_pcr.cu), K2
     (kernels/csrc/normal_eq.cu) and K3 (kernels/csrc/visible_count.cu),
     one nvcc each, started together;
  3. K1 against its plain PyTorch twin on the card (B=9 λ candidates,
     N in {5, 64, 257, 448}, Jacobi-scaled blocks): relative error
     <= 1e-9 in f64 (also against the Thomas solve) and <= 1e-4 in f32;
     the kernel's and the twin's times and the bound at B=9 in f64 for
     N in {64, 128, 256, 448, 1024} and at N=448 in f32, with the device
     kernels of one call (the nodes of its CUDA graph; must be 1: one
     cooperative launch) and its device time under torch.profiler; at
     N=448 in f64 that of torch.linalg.solve on the assembled dense
     (9N x 9N) systems;
  4. the streaming slice: orbit determination of the committed 10800 s
     fixture (tests/data/torch_stream_seed1.npz) through the port's
     run_streaming on cuda in f64, once cold and once timed, held to the
     JAX package's result in the fixture (window count, time to 5 km,
     final error within 0.01 km), with K1's launch count from that run
     and the (B, N) shapes it was launched at;
  5. the tail refinement (refine_terminal, rigid chain) of the stream's
     final states over the whole arc on cuda — the bench arc ends on a
     detection knot, so the stream itself never runs it — against the JAX
     result in the fixture: relative 1e-6;
  6. the simulator, mode a (bench.py's along-track arc) from the JAX
     draws in tests/data/torch_sim_seed1.npz, on cuda: JAX's rows
     (3112; frame equal, lon/lat within 1e-9 deg, pixels within 1e-6 px,
     confidence within 1e-12) and gate, then streamed: 7 windows, 275.0 s
     to 5 km, final error within 0.01 km of JAX's 0.474706;
  7. the simulator, mode b (an orbit of the synthetic full eval: 7920
     landmarks, 10801 frames) from the fixture's draws: the gate at every
     frame and the rows as in 6, with the wall and the peak memory, and
     where the wall goes (µs per orbit and per attitude RK4 step, the
     detection stage alone);
  8. K3 against its plain twin on the card at mode b's inputs (10801
     footprints x 7920 landmarks; the landmarks region by region as the
     simulator gives them, and in a seeded random order) in f64 and f32,
     and a small case of wrapped, empty and NaN boxes: counts equal; both
     times, the device kernels (graph nodes, at most 3) and device µs of
     one call, the compare instructions a pair of the pair loops
     (cuobjdump -sass), the pairs left by the exact tile cull, and two
     bounds at the CUDA cores' issue rate: after the cull, and by brute
     force;
  9. the main path from the port's own generator: simulate_sequence(1)
     in mode a on cuda, then streamed: finite, >= 2 windows,
     final error under 5 km, with the K3 and K1 launch counts of that run;
 10. K2 against its plain twin on the card at the long arc's shape (2168
     knots, D=4, random J, r, w from a seed): relative error <= 1e-12 in
     f64 and <= 1e-5 with f32=True; the kernel's call time (20 calls back
     to back), its device time and device kernels a call (graph nodes)
     in both modes (must be 1), the twin's and the two einsums'
     (dist/sharded_ba.py:226-227 of the JAX package) times;
 11. the long arc (config 5(a)) from JAX's data: the committed sequence of
     tests/data/torch_longarc_seed1.npz through the port's
     build_sharded_problem (initial states within 1e-12 of JAX's) and
     solve_long_arc on cuda at n_arc 8, f64, 20 iterations (8
     vision-only): states after the first iteration within 1e-9 relative
     of JAX's, final per-knot errors within 0.01 km and the median within
     1e-3 km; K2's launches in that run (20), the wall of a timed run,
     and two iterations under torch.profiler (device kernels per
     iteration, the device-busy share of the wall, K2's device time per
     launch);
 12. the port's own long arc: simulate_sequence(1, duration_s=10800,
     frame_stride=5, along_track=True) on cuda, then solved as in 11:
     finite, median error under 5 km, K3 and K2 launched;
 13. config 4, the constellation, from JAX's data: the 8 sequences of
     tests/data/torch_constellation.npz (seeds 0-7, 3600 s, frame_stride
     5, along track) simulated on cuda from JAX's draws (rows as in 6),
     prepared as one batch (JAX's orbits, n_pad and m_pad) and solved by
     one solve_window_batch, 20 iterations (10 vision-only), f64: states
     after iteration 1 within 1e-9 relative of JAX's, each orbit's median
     error within 1e-3 km of JAX's; every K1 launch of the solve at
     (B, N) = (orbits, n_pad); the batched wall and orbit-frames/s, the
     peak device memory; the same 8 problems solved one at a time through
     the single-orbit _solve_window (equal within 1e-9, their wall); one
     batched and one single-orbit iteration under torch.profiler; K1 at
     (8, n_pad) against its twin: 1e-9 on random scaled blocks; on the
     run's first system (ill-conditioned blocks) 3e-8, beside Thomas and
     the dense LU, and a backward error of 1e-14; on its last system
     3e-11; its time, device time, bound and the dense
     torch.linalg.solve's time;
 14. the evaluation: the mode-b sequence of 7 streamed on cuda and held
     to tests/data/torch_eval_seed1.npz (windows and time to 5 km equal,
     final error within 0.01 km, terminal_crlb_km's three bounds within
     1e-6 relative); then run_batch_eval([0, 1]) at 3600 s from the
     port's own generator: a finite summary and its per-orbit rows;
 15. the f32 stream: torch's f32 matmuls checked true f32 (no TF32), the
     fixture of 4 streamed with StreamingConfig(dtype="float32"), once
     cold and once timed: 7 windows, 275.0 s to 5 km, final error within
     0.01 km of JAX's f64 result, of JAX's f32 run
     (tests/data/torch_modes_seed1.npz) and of phase 4's; the walls beside
     phase 4's, the seconds in the f64 escapes (window 0's init, the
     ladder's f64 rung), K1's launches by (dtype, B, N); K1 on the run's
     first and last f32 systems against its twin and against f64 Thomas,
     with backward errors, and timed at the last one's shape; the stream
     again without window 0's f64 init (printed, not gated); a forced
     escalation (recover_rms_px=1e-3, the fixed 20-iteration budget) on
     config 3's gapped sequence: every window trips, finite, min error
     < 2 km;
 16. BASELINE configs 1-3 (vinsat_tpu_torch/run_configs.py) on JAX's rows
     from the same fixture, held knot by knot through the streams and
     EKF passes each runner makes (recorded as it makes them): config 1's
     errors within 1e-6 km of JAX's, with the device kernels of one EKF
     knot; config 2's median within 1e-3 km of JAX's Thomas-solve run
     (its f64 "auto" run beside it), K1 timed at config 2's shape; config
     3's matcher indices equal to JAX's, its BA-only and hybrid streams'
     recorded times (so windows) and time to 5 km equal and errors within
     1e-4 km, the EKF-only passes' errors within 1e-6 km; then config 3
     from the port's own generator (finite, BA-only and hybrid under
     5 km, K3 launched); each config's wall, peak device memory and K1
     launches by shape;
 17. the stream modes on the bench rows of 4 (JAX's results in
     tests/data/torch_dist_stream_seed1.npz), under torch's deterministic
     kernels: a track_nees stream checkpointed at every window (7 NEES
     samples, JAX's recorded times, each window's terminal marginal within
     1e-6 relative (Frobenius) of JAX's, its estimate within 0.01 km,
     block_nees on JAX's samples within 1e-6 of JAX's values), resumed
     from its w0 and w3 checkpoints (equal to the uninterrupted run: times,
     errors and final states within 1e-12 relative) and from JAX's w0
     checkpoint (JAX's final within 0.01 km); a bounded stream with
     auto_calibrate (JAX's times, final within 0.01 km); an early-stop
     stream (conv_patience 5): the LM iterations of every window solve
     equal to JAX's, final within 0.01 km;
 18. config 5(b), stream_orbit_sharded on a 1x8 mesh from JAX's rows (max
     30 iterations, seed 1) in f64 at the default dispatch (every window on
     one shard), with shard_min_knots=0 (every window on the 8 shards) and
     bounded: each window's route, n_pad and d_pad (JAX's), K2's launches
     by (dtype, N, D); JAX's recorded times, every error within 1e-6 km
     (tightened from 1e-4 on the card's 1.4e-9 / 7.4e-9 km), the final
     within 0.01 km; K2 launched at some D != 4; then in f32 on
     the 8 shards under torch's deterministic kernels: every knot and the
     final within 0.01 km of JAX's f32 run, the final within 0.05 km of
     the f64 one (a near tie of the last window's best iterate in f32), K2
     launched in f32; K2 timed at the largest (N, D) of the f64 and the
     f32 run;
 19. configs 4, 5(a) and 2 in f32 on JAX's data: config 4 (phase 13's
     sequences): every K1 launch at (8, 768) in f32, each orbit's median
     within 0.01 km of JAX's f32 median and 0.02 km of its f64 one (JAX's
     own f32 medians lie up to 0.005 km from its f64), K1 timed on the run's
     last f32 system; config 5(a): median within 0.01 km of JAX's f32, 20
     K2 launches in f32; config 2 (run_fullbatch): median within 0.01 km
     of JAX's f32, every K1 launch at (1, 768) in f32, K1 timed on its
     last system;
 20. the arc shards on torch.distributed ranks (dist/launch.py): its
     selftest, ba-step and stream programs spawned at 2 processes x 2
     shards on this card (gloo: the ranks share it), each worker holding
     its rank run against the one-process layout at the same n_arc
     (1e-12 relative, 1e-10 relative, 1e-6 km a knot) besides the JAX
     launcher's gates, with its backend, device, walls and launches of
     K2 (1 in ba-step, 16 in stream) and K3 (1, the stream's simulation);
     the same at one rank a card over nccl where there are two cards or
     more; then dist/bench_scaling.py's overhead rows at base_knots 64
     and 256 and its dispatch scan, 3 repeats, f32;
 21. the hi-fi truth: tests/data/torch_hifi_seed1.npz's arc (JAX's
     simulate_sequence(1, duration_s=1800, frame_stride=10,
     along_track=True, hifi_truth=True)) simulated on cuda from JAX's
     draws: the trajectory within 1e-10 km of JAX's at every second, the
     rows and gate as in 6, K3 launched once; µs per hi-fi orbit RK4 step
     beside phase 7's reference step; the arc streamed (two-body + J2):
     finite, final error under 5 km; generate_constellation of 8 orbits x
     600 s as one batched rollout, equal to the 8 single rollouts within
     1e-12;
 22. the imagery path (pipeline.simulate_imagery_from_draws /
     simulate_sequence_imagery): the two JAX runs of
     tests/data/torch_imagery_seed1.npz replayed on cuda from JAX's draws
     and region rasters, (a) the NCC detector at 60 classes, (b) the
     committed PatchCNN (tests/data/detector_full_snr1.npz) at 10:
     the crops' windows within 1e-9 deg of JAX's, per-crop scores within
     1e-5 and positions within 1e-3 px where JAX's score is above 0.3 (a)
     or 0 (b), rows with JAX's frames, classes within 1e-9 deg, pixels
     within 1e-3 px, confidences within 1e-5 (no JAX candidate within
     1e-4 of the gate), streamed within 1e-4 km of JAX's errors (JAX's own
     rows through the port's stream within 1e-6 km); TF32 off at every
     convolution, dense layer and einsum of the detection stage; then the
     port's own seed 1 at the entry point's defaults (600 s, stride 30,
     60 classes), its 10800 s arc at stride 30 (final error under 5 km)
     with the NCC detector and its 1800 s arc with the PatchCNN (min
     error under 5 km), whose windows hold too few knots for K1, and the
     two arcs whose streams launch K1: 1800 s at stride 10 with the NCC
     detector (min error under 5 km) and 600 s at stride 1 with the
     PatchCNN (the median pixel error of the rows the stream keeps, conf
     > 0.8, under the reference's 10 px); per run the stages' seconds,
     the µs a crop of detection, that pixel error, the peak device
     memory (with what earlier phases hold) and K1's
     launches; the detection stage alone under torch.profiler (device
     busy share, the CNN's patches/s).
Each phase prints its seconds.  The last two lines are the card's
nvidia-smi line and the device JSON line; the kernels' JSON record comes
before them.  Needs torch with CUDA and nvcc; imports no JAX.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
STREAM_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_stream_seed1.npz")
SIM_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_sim_seed1.npz")
LONGARC_FIXTURE = os.path.join(ROOT, "tests", "data",
                               "torch_longarc_seed1.npz")
CONST_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_constellation.npz")
EVAL_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_eval_seed1.npz")
MODES_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_modes_seed1.npz")
DIST_FIXTURE = os.path.join(ROOT, "tests", "data",
                            "torch_dist_stream_seed1.npz")
HIFI_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_hifi_seed1.npz")
IMAGERY_FIXTURE = os.path.join(ROOT, "tests", "data",
                               "torch_imagery_seed1.npz")
DETECTOR_FIXTURE = os.path.join(ROOT, "tests", "data",
                                "detector_full_snr1.npz")
K1_SOURCE = "vinsat_tpu_torch/kernels/csrc/tridiag_pcr.cu"
K1_REPLACES = "vinsat_tpu/kernels/tridiag_pallas.py:157"
K3_SOURCE = "vinsat_tpu_torch/kernels/csrc/visible_count.cu"
K3_REPLACES = "vinsat_tpu/kernels/matching.py:49"
K2_SOURCE = "vinsat_tpu_torch/kernels/csrc/normal_eq.cu"
K2_REPLACES = "vinsat_tpu/kernels/normal_eq.py:54"
DURATION_S = 10800
# the evaluation loop's arcs in phase 14 (cut from 10800 s to keep the
# script inside its 1200 s limit with phases 17-19 added)
EVAL_DURATION_S = 3600
K1_TIME_N = (64, 128, 256, 448, 1024)
# H100 SXM data-sheet peaks at 700 W: f64 on the tensor cores (34 TFLOP/s
# outside them), f32 outside them (their TF32 is not f32), HBM3 bandwidth
PEAK_F64, PEAK_F32, PEAK_BYTES = 67e12, 67e12, 3.35e12
# the CUDA cores' issue rates, instructions/s: an FMA (two flops) and a
# compare are one instruction each; compares never run on the tensor cores
INSTR_F64, INSTR_F32 = 34e12 / 2, 67e12 / 2
PAD_CYCLES = 2_000_000  # ~1 ms spin around each profiled call


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


def _dense(D, U):
    """The assembled (B, 9N, 9N) matrix of the block-tridiagonal system."""
    import torch

    Bn, N, k, _ = D.shape
    A = D.new_zeros(Bn, N, k, N, k)
    i = torch.arange(N, device=D.device)
    A[:, i, :, i, :] = D.transpose(0, 1)
    A[:, i[:-1], :, i[1:], :] = U.transpose(0, 1)
    A[:, i[1:], :, i[:-1], :] = U.transpose(0, 1).transpose(-1, -2)
    return A.reshape(Bn, N * k, N * k)


def _backward(D, U, b, x) -> float:
    """Normwise backward error of x for the block-tridiagonal system:
    max |A x - b| / (max |D| max |x| + max |b|).  A stable solve gives a
    few ulp whatever the conditioning."""
    r = (D @ x[..., None])[..., 0] - b
    r[:, :-1] += (U @ x[:, 1:, :, None])[..., 0]
    r[:, 1:] += (U.transpose(-1, -2) @ x[:, :-1, :, None])[..., 0]
    return float(r.abs().max()
                 / (D.abs().max() * x.abs().max() + b.abs().max()))


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


def _alternate(plain, kernel, reps: int = 20):
    """Times in turns plain, kernel, kernel, plain on one card: (kernel ms,
    plain ms, the four readings)."""
    p1 = _time_ms(plain, reps)
    k1 = _time_ms(kernel, reps)
    k2 = _time_ms(kernel, reps)
    p2 = _time_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2, (p1, k1, k2, p2)


def _device_profile(fn):
    """Run fn once under torch.profiler, tracing the device only (host-op
    events would multiply the trace's size): (host wall s, {device kernel
    or copy name: (count, device µs)}); the dict is empty where the
    profiler sees no device activity.  A ~1 ms spin kernel runs before and
    after fn inside the trace, and is left out of the dict: the profiler
    has been seen to drop the events of short kernels at a trace's edges."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
        torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
    per = {e.key: (e.count, e.self_device_time_total)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and "spin_kernel" not in e.key}
    return wall, per


def _bound_ms(ops: float, peak: float, nbytes: float):
    """The least time for `ops` operations at `peak` and `nbytes` at the
    memory rate: (ms, what bounds it)."""
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def _pcr_flops(B: int, N: int) -> float:
    """Floating-point operations K1's PCR needs on B systems of N 9x9 block
    rows, leaving out the blocks that are zero by structure: before level s
    row i holds L_i only for i >= s and U_i only for i < N - s.  Per level
    and row: the pivot-free Gauss-Jordan of [D | L U b], where pivot p takes
    a division and 8 FMAs in each column not yet reduced (the 8 - p of D
    right of it, b, and L's and U's where present); then the update, a 9x9
    block product and a block-vector product with their subtractions for
    each of L_i and U_i present, and L'_i (U'_i) only where it is not zero,
    so never at the last level.  Last, the 9 x 10 solve of each row."""
    k = 9
    col = 1 + 2 * (k - 1)  # one column at one pivot
    d_cols = k * (k - 1) // 2  # D's columns left to reduce, over the pivots
    mm, mv = 2 * k**3, 2 * k * k
    total = N * col * (d_cols + k)  # the final solves
    s = 1
    while s < N:
        n_side = N - s  # rows holding L (as many hold U)
        n_next = max(N - 2 * s, 0)  # rows whose L' (U') is not zero
        total += col * (N * (d_cols + k) + 2 * n_side * k * k)
        total += 2 * n_side * (mm + k * k + mv + k) + 2 * n_next * mm
        s *= 2
    return B * total


def _graph_nodes(fn) -> int:
    """Device operations of one call of fn: the call captured in a CUDA
    graph (after a warm call on a side stream) and the graph's nodes
    counted by libcuda (cuGraphGetNodes): every kernel launch, memset
    and copy the call puts on the stream is one node."""
    import ctypes

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    get = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    get.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_size_t)]
    get.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    rc = get(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUDA error {rc}")
    return n.value


def _per_call(fn, args, tries: int = 5, **kw):
    """One call fn(*args, **kw) on the device: (device kernels a call,
    their device µs a call, {kernel name: device µs a call}).  The kernels
    are the nodes of the call's CUDA graph (`_graph_nodes`); the µs come
    from torch.profiler, one call a trace, the mean over those of `tries`
    traces that saw as many kernels (the profiler has been seen to drop
    short kernels' events), or None and {} where none did."""
    call = lambda: fn(*args, **kw)  # noqa: E731
    n = _graph_nodes(call)
    full = []
    for _ in range(tries):
        _, per = _device_profile(call)
        if sum(c for c, _ in per.values()) == n:
            full.append(per)
    if not full:
        return n, None, {}
    split = {k: sum(p.get(k, (0, 0.0))[1] for p in full) / len(full)
             for k in full[0]}
    return n, sum(split.values()), split


def _us(x) -> str:
    return "not measured" if x is None else f"{x:.2f}"


@contextlib.contextmanager
def _patched(module, name, hook):
    """module.name replaced, inside the block, by hook(original, *args,
    **kw): how the script records what the main path calls."""
    orig = getattr(module, name)
    setattr(module, name, lambda *a, **kw: hook(orig, *a, **kw))
    try:
        yield
    finally:
        setattr(module, name, orig)


def _k1_recording(on_launch):
    """Inside the block every K1 launch is first shown to
    on_launch(D, U, b)."""
    from vinsat_tpu_torch.kernels import tridiag_pcr

    def hook(launch, D, U, b):
        on_launch(D, U, b)
        return launch(D, U, b)

    return _patched(tridiag_pcr, "_launch", hook)


def _k1_at_shape(D, U, b, peak: float, what: str, smi: str) -> dict:
    """K1 timed on one system (D, U, b) beside its plain twin (in turns)
    and the dense torch.linalg.solve, with its bound at `peak`, the device
    kernels of a call (checked to be 1) and their device time: prints the
    `K1 time` line and returns the shape's record for the kernels JSON."""
    import torch
    from vinsat_tpu_torch.kernels import tridiag_pcr

    solve = tridiag_pcr.block_tridiag_solve_pcr
    plain = tridiag_pcr.block_tridiag_solve_pcr_plain
    B, N = D.shape[:2]
    dtype = str(D.dtype)[6:]
    ms, plain_ms, r = _alternate(lambda: plain(D, U, b),
                                 lambda: solve(D, U, b))
    n_dev, dev_us, _ = _per_call(solve, (D, U, b))
    flops = _pcr_flops(B, N)
    bound = _bound_ms(flops, peak, D.element_size()
                      * (D.numel() + U.numel() + 2 * b.numel()))
    A, rhs = _dense(D, U), b.reshape(B, -1, 1)
    lib_ms = _time_ms(lambda: torch.linalg.solve(A, rhs), reps=2)
    del A
    print(f"K1 time N={N} B={B} {dtype} ({what}): kernel {ms:.4f} ms "
          f"({r[1]:.4f}, {r[2]:.4f}), plain {plain_ms:.4f} ms ({r[0]:.4f}, "
          f"{r[3]:.4f}), dense torch.linalg.solve {lib_ms:.4f} ms, bound "
          f"{bound[0]:.4f} ms ({bound[1]}; {flops / 1e6:.1f} Mflop), "
          f"{n_dev} device kernels per call (CUDA graph), {_us(dev_us)} µs "
          f"of device time a call (torch.profiler); rows {B * N} against "
          f"{tridiag_pcr.resident_warps(D.dtype)} resident warps  [{smi}]")
    _check(n_dev == 1, ("K1 device kernels per call", what, n_dev))
    return {"B": B, "N": N, "dtype": dtype, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib_ms,
            "device_us": dev_us}


def _k1_times(solve, plain, dev, smi):
    """K1's kernel and plain-twin times (CUDA events, in turns) and its
    bound at B=9, in f64 at each N of K1_TIME_N and in f32 at N=448, with
    the device kernels a call and their device time (`_per_call`): {(N,
    dtype name): (ms, plain ms, (bound ms, bound by), kernels per call)}."""
    import numpy as np
    import torch

    rng = np.random.default_rng(3)
    rows = {}
    cases = [(N, torch.float64) for N in K1_TIME_N] + [(448, torch.float32)]
    for N, dtype in cases:
        D, U, b = (torch.as_tensor(a, dtype=dtype, device=dev)
                   for a in _problem(rng, 9, N))
        ms, p_ms, r = _alternate(lambda: plain(D, U, b),
                                 lambda: solve(D, U, b))
        bnd = _bound_ms(_pcr_flops(9, N),
                        PEAK_F64 if dtype == torch.float64 else PEAK_F32,
                        D.element_size() * (D.numel() + U.numel()
                                            + 2 * b.numel()))
        n_dev, dev_us, _ = _per_call(solve, (D, U, b))
        tag = str(dtype)[6:]
        print(f"K1 time N={N} B=9 {tag}: kernel {ms:.4f} ms ({r[1]:.4f}, "
              f"{r[2]:.4f}), plain {p_ms:.4f} ms ({r[0]:.4f}, {r[3]:.4f}), "
              f"bound {bnd[0]:.4f} ms ({bnd[1]}), {n_dev} device kernels "
              f"per call (CUDA graph), {_us(dev_us)} µs of device time a "
              f"call (torch.profiler)"
              f"  [{smi}]")
        rows[(N, tag)] = (ms, p_ms, bnd, n_dev)
    return rows


def _k3_compares(lib_path: str):
    """Compare instructions a pair that K3's pair loops issue, read from
    `cuobjdump -sass` of the built library: {dtype: (a loop testing one
    box, the loop testing lon and lon + 360)} and where the numbers come
    from.  The pair loops are the count kernel's innermost loops that read
    shared memory and no global memory; each pass covers PAIR_UNROLL
    landmarks (read from the source).  Without cuobjdump, or where no such
    loop is found: the source's 4 and 6 compares."""
    import re
    from pathlib import Path

    from vinsat_tpu_torch.kernels import _build

    counted = {"float64": (4, 6), "float32": (4, 6)}
    with open(os.path.join(ROOT, K3_SOURCE)) as fh:
        unroll = int(re.search(r"PAIR_UNROLL = (\d+);", fh.read()).group(1))
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    try:
        sass = subprocess.run([str(tool), "-sass", lib_path],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
    except (OSError, subprocess.SubprocessError):
        return counted, "counted in the source (no cuobjdump)"
    found = {}
    for fn_text in sass.split("Function : ")[1:]:
        name = fn_text.split(None, 1)[0]
        tag = ("float64" if "count_kernelIdE" in name else
               "float32" if "count_kernelIfE" in name else None)
        if tag is None:
            continue
        ins = [(int(a, 16), i) for a, i in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn_text)]
        loops = []
        for a, i in ins:
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", i)
            if m and int(m.group(1), 16) < a:
                loops.append((int(m.group(1), 16), a))
        per = set()
        for lo, hi in loops:
            if any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi)
                   for l2, h2 in loops):
                continue  # not innermost
            body = [i for a, i in ins if lo <= a <= hi]
            if (any("LDS" in i for i in body)
                    and not any("LDG" in i for i in body)):
                per.add(sum(bool(re.search(r"\b[DF]SETP", i))
                            for i in body) / unroll)
        if per:
            found[tag] = (min(per), max(per))
    if set(found) != set(counted):
        return counted, "counted in the source (no pair loop in the SASS)"
    return found, f"cuobjdump -sass, {unroll} landmarks a loop pass"


def _k3_work(args, per_pair):
    """What K3's pair loops must run on these inputs after the exact cull,
    from the tile boxes' plain twin: (pairs left, compare instructions
    they take, pairs at a warp's granularity -- what the kernel runs).  A
    (frame, tile) is left where the frame's box meets the tile's lon or
    lon + 360 box by the count's own compares; per_pair = (one box, both)."""
    import torch

    from vinsat_tpu_torch.kernels import visible_count

    bounds, lon, lat, best = args
    tile = visible_count.TILE
    boxes = visible_count.tile_boxes_plain(lon, lat, best)
    a0, b0, a1, b1 = (bounds[:, i:i + 1] for i in range(4))
    lat_ok = (b0 < boxes[:, 5]) & (boxes[:, 4] < b1)
    hit_lon = lat_ok & (a0 < boxes[:, 1]) & (boxes[:, 0] < a1)
    hit_w = lat_ok & (a0 < boxes[:, 3]) & (boxes[:, 2] < a1)
    L = lon.shape[0]
    size = torch.full((boxes.shape[0],), float(tile), device=lon.device,
                      dtype=torch.float64)
    size[-1] = L - tile * (boxes.shape[0] - 1)
    either, both = hit_lon | hit_w, hit_lon & hit_w
    pairs = float((either.double() * size).sum())
    instr = float((either.double() * size).sum() * per_pair[0]
                  + (both.double() * size).sum() * (per_pair[1] - per_pair[0]))
    F = bounds.shape[0]
    warp = torch.nn.functional.pad(either, (0, 0, 0, -F % 32))
    warp = warp.view(-1, 32, either.shape[1]).any(1)
    return pairs, instr, float((warp.double() * size).sum() * 32)


def _rows_check(tag, got, want, lonlat_tol):
    """Rows of the port against JAX's: count and frames equal, lon / lat
    within lonlat_tol deg, pixels within 1e-6 px, confidence 1e-12."""
    import numpy as np

    _check(got.shape == want.shape, (tag, got.shape, want.shape))
    d_ll = float(np.abs(got[:, 1:3] - want[:, 1:3]).max())
    d_uv = float(np.abs(got[:, 3:5] - want[:, 3:5]).max())
    d_c = float(np.abs(got[:, 5] - want[:, 5]).max())
    print(f"{tag}: {len(got)} rows (JAX {len(want)}), max |d lon/lat| "
          f"{d_ll:.3e} deg, max |d uv| {d_uv:.3e} px, max |d conf| {d_c:.3e}")
    _check(np.array_equal(got[:, 0], want[:, 0]), (tag, "frames"))
    _check(d_ll <= lonlat_tol and d_uv <= 1e-6 and d_c <= 1e-12,
           (tag, d_ll, d_uv, d_c))


def _fixture_draws(fx, mode):
    import numpy as np

    from vinsat_tpu_torch import pipeline
    from vinsat_tpu_torch.sim import detections, orbits

    g = lambda k: fx[f"{k}_{mode}"]  # noqa: E731
    return pipeline.SimDraws(
        orbits.OrbitalElements(*(float(v) for v in g("oe"))),
        np.asarray(g("q0")), np.asarray(g("w0")), int(g("db_seed")),
        detections.RecordedDraws(g("score_frame"), g("score_landmark"),
                                 g("score"), g("noise"), g("conf")))


@contextlib.contextmanager
def _deterministic():
    """torch's deterministic kernels inside the block (index_add_ on the
    card sums with atomics otherwise, whose order changes the last bits
    from run to run); ops without one only warn, silenced here."""
    import warnings

    import torch

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.use_deterministic_algorithms(was)


def _phase17(dev, smi) -> dict:
    """17. The stream modes on the card, from the bench fixture; returns
    K1's launches by run."""
    import tempfile

    import numpy as np
    from vinsat_tpu_torch.estimation import ba, window
    from vinsat_tpu_torch.evalx import calibration
    from vinsat_tpu_torch.kernels import tridiag_pcr

    fx, dfx = np.load(STREAM_FIXTURE), np.load(DIST_FIXTURE)
    rows, orbit, seed = fx["det_rows"], fx["orbit_pos_eci_km"], int(fx["seed"])
    solve = tridiag_pcr.block_tridiag_solve_pcr
    launches = {}

    def stream(key, tag, cfg, **kw):
        solve.launches = 0
        t0 = time.time()
        res = window.stream_orbit(rows, orbit, seed=seed, cfg=cfg,
                                  device=dev, **kw)
        launches[key] = solve.launches
        print(f"{tag}: {time.time() - t0:.2f} s, final {res.errors[-1]:.6f} "
              f"km, {len(res.times)} recorded errors, K1 launches "
              f"{solve.launches}  [{smi}]")
        _check(np.isfinite(res.errors).all() and solve.launches > 0,
               (tag, "finite, K1 launched"))
        return res

    def same_run(tag, got, want):
        """got equals the uninterrupted run: times equal, errors and final
        states within 1e-12 relative."""
        same_t = np.array_equal(got.times, want.times)
        d_e = (float(np.abs(got.errors - want.errors).max()
                     / np.abs(want.errors).max()) if same_t else np.inf)
        d_s = float(np.abs(got.final_states - want.final_states).max()
                    / np.abs(want.final_states).max())
        print(f"{tag}: times equal to the uninterrupted run's: {same_t}, "
              f"errors rel {d_e:.3e}, final states rel {d_s:.3e}")
        _check(same_t and d_e <= 1e-12 and d_s <= 1e-12, (tag, d_e, d_s))

    with tempfile.TemporaryDirectory() as d, _deterministic():
        ck = os.path.join(d, "ck")
        nees = stream("nees", "NEES stream (track_nees), checkpointed every "
                      "window",
                      window.StreamingConfig(track_nees=True),
                      checkpoint_path=ck)
        infos, jinfos = nees.window_infos, dfx["nees_window_infos"]
        _check(infos is not None and len(infos) == len(jinfos) == 7,
               ("NEES samples", None if infos is None else len(infos)))
        _check(np.array_equal(nees.times, dfx["nees_times"]), "NEES times")
        d_info = max(float(np.linalg.norm(h - hj) / np.linalg.norm(hj))
                     for h, hj in zip(infos, jinfos))
        d_est = float(np.abs(nees.window_est[:, :3]
                             - dfx["nees_window_est"][:, :3]).max())
        d_gt = float(np.abs(nees.window_gt - dfx["nees_window_gt"]).max())
        # the calibration functions on JAX's own samples, and on the run's
        bn_j = np.array([[calibration.block_nees(e, g, h)[k]
                          for k in ("pos", "rot", "vel")] for h, e, g in zip(
                              jinfos, dfx["nees_window_est"],
                              dfx["nees_window_gt"])])
        d_fn = float(np.abs(bn_j / dfx["nees_block"] - 1.0).max())
        bn = np.array([[calibration.block_nees(e, g, h)[k]
                        for k in ("pos", "rot", "vel")] for h, e, g in zip(
                            infos, nees.window_est, nees.window_gt)])
        print(f"NEES: window marginals rel (Frobenius) vs JAX max "
              f"{d_info:.3e}; window estimates max |d| {d_est:.3e} km, GT "
              f"{d_gt:.3e} km; block_nees on JAX's samples rel vs JAX "
              f"{d_fn:.3e}; the run's block NEES (pos, rot, vel) by window: "
              + "; ".join(f"{a:.4g}, {b:.4g}, {c:.4g}" for a, b, c in bn)
              + " (JAX: " + "; ".join(f"{a:.4g}, {b:.4g}, {c:.4g}"
                                      for a, b, c in dfx["nees_block"])
              + ")")
        _check(d_info <= 1e-6 and d_fn <= 1e-6 and d_est <= 0.01
               and d_gt <= 1e-9, ("NEES", d_info, d_fn, d_est, d_gt))
        c = calibration.calibrate_inflation(infos, nees.window_est,
                                            nees.window_gt)
        print("NEES: calibrated inflation " + json.dumps(c)
              + ", equivalent floors "
              + json.dumps(calibration.floors_from_inflation(infos, c)))
        for w in (0, 3):
            same_run(f"resumed from w{w}", stream(
                f"resume_w{w}",
                f"NEES stream resumed from its w{w} checkpoint",
                window.StreamingConfig(track_nees=True),
                resume_from=f"{ck}.w{w}.npz"), nees)
        # the JAX package's w0 checkpoint of the same run
        np.savez(os.path.join(d, "jax.w0.npz"), **{
            k[len("ckpt_w0_"):]: dfx[k] for k in dfx.files
            if k.startswith("ckpt_w0_")})
        rj = stream("resume_jax_w0",
                    "NEES stream resumed from JAX's w0 checkpoint",
                    window.StreamingConfig(track_nees=True),
                    resume_from=os.path.join(d, "jax.w0.npz"))
        f_j = float(dfx["nees_errors"][-1])
        print(f"resumed from JAX's w0: final {rj.errors[-1]:.6f} km, JAX's "
              f"uninterrupted {f_j:.6f} km")
        _check(np.array_equal(rj.times, dfx["nees_times"])
               and abs(rj.errors[-1] - f_j) <= 0.01, ("JAX w0", rj.errors[-1]))

    auto = stream("auto_calibrate",
                  "bounded stream, anchor prior auto-calibrated",
                  window.StreamingConfig(marginalize=True,
                                         auto_calibrate=True))
    f_a = float(dfx["autocal_errors"][-1])
    same_a = np.array_equal(auto.times, dfx["autocal_times"])
    print(f"auto_calibrate: times equal to JAX's {same_a}, final "
          f"{auto.errors[-1]:.6f} km (JAX {f_a:.6f}), NEES samples "
          f"{len(auto.window_infos)}")
    _check(same_a and abs(auto.errors[-1] - f_a) <= 0.01,
           ("auto_calibrate", auto.errors[-1], f_a))

    # the early stop: the LM iterations of every window solve, counted
    count, iters = [0], []

    def counted_iteration(run, *a, **kw):
        count[0] += 1
        return run(*a, **kw)

    def counted_solve(run, *a, **kw):
        count[0] = 0
        out = run(*a, **kw)
        iters.append(count[0])
        return out

    solver = ba.SolverParams(**json.loads(str(dfx["early_solver_kwargs"])))
    with _patched(ba, "ba_iteration", counted_iteration), \
            _patched(window, "_solve_window", counted_solve):
        early = stream("early_stop", f"early-stop stream (conv_patience "
                       f"{solver.conv_patience})", window.StreamingConfig(),
                       solver=solver)
    f_e = float(dfx["early_errors"][-1])
    print(f"early stop: iterations by window solve {iters} (JAX "
          f"{dfx['early_iters'].tolist()}), final {early.errors[-1]:.6f} km "
          f"(JAX {f_e:.6f}); one host sync an iteration past num_iters")
    _check(iters == dfx["early_iters"].tolist()
           and abs(early.errors[-1] - f_e) <= 0.01,
           ("early stop", iters, early.errors[-1]))
    return launches


def _phase18(dev, smi) -> dict:
    """18. Config 5(b), the sharded stream, on the card from JAX's rows;
    returns K2's launches and its timing at the largest (N, D) of the
    forced run."""
    import numpy as np
    import torch
    from vinsat_tpu_torch.dist import mesh, sharded_ba
    from vinsat_tpu_torch.dist import stream as dstream
    from vinsat_tpu_torch.estimation import window
    from vinsat_tpu_torch.kernels import normal_eq

    dfx = np.load(DIST_FIXTURE)
    rows, orbit = dfx["det_rows_5b"], dfx["orbit_pos_eci_km_5b"]
    seed, n_arc = int(dfx["seed"]), int(dfx["n_arc"])
    mesh8 = mesh.make_mesh(1, n_arc, device=dev)
    k2 = normal_eq.assemble_normal_eq
    out = {"launches": {}}

    def run(tag, cfg_kw, **kw):
        """The sharded stream with each window's route and budget and K2's
        launches by (dtype, N, D) recorded."""
        builds, routes = [], []
        k2_by = collections.Counter()
        biggest = []

        def on_build(build, *a, **k):
            builds.append(tuple(a[7:9]))  # (n_pad, d_pad)
            return build(*a, **k)

        def on_solver(make, m, *a, **k):
            routes.append(f"{m.n_orbit}x{m.n_arc}")
            return make(m, *a, **k)

        def on_k2(assemble, J, r, w, f32=False):
            k2_by[(str(J.dtype)[6:], J.shape[0], J.shape[1])] += 1
            if not biggest or J.numel() > biggest[0].numel():
                biggest[:] = [t.clone() for t in (J, r, w)]
            return assemble(J, r, w, f32=f32)

        cfg = window.StreamingConfig(max_iters=30, **cfg_kw)
        k2.launches = 0
        t0 = time.time()
        with _patched(dstream, "_build_window_problem", on_build), \
                _patched(sharded_ba, "make_sharded_window_solver",
                         on_solver), \
                _patched(sharded_ba, "assemble_normal_eq", on_k2):
            res = dstream.stream_orbit_sharded(rows, orbit, mesh8, seed=seed,
                                               cfg=cfg, **kw)
        wall = time.time() - t0
        launches = k2.launches
        out["launches"][tag] = launches
        jt, je = dfx[f"b5_{tag}_times"], dfx[f"b5_{tag}_errors"]
        same_t = np.array_equal(res.times, jt)
        d = float(np.abs(res.errors - je).max()) if same_t else np.inf
        # the window problems built: the f32 run builds window 0 twice
        # (again from its f64 init)
        print(f"5(b) {tag}: {wall:.2f} s, windows (route, n_pad, d_pad): "
              + ", ".join(f"({r}, {b[0]}, {b[1]})"
                          for r, b in zip(routes, builds[-len(routes):]))
              + f"; builds {builds} (JAX "
              f"{dfx[f'b5_{tag}_shapes'].tolist()}); K2 launches {launches} "
              "by (dtype, N, D): "
              + ", ".join(f"{k[0]} {k[1]}x{k[2]}: {c}"
                          for k, c in sorted(k2_by.items()))
              + f"; times equal to JAX's {same_t}, per-knot max |d| vs JAX "
              f"{d:.3e} km, final {res.errors[-1]:.6f} km (JAX "
              f"{je[-1]:.6f})  [{smi}]")
        _check(np.isfinite(res.errors).all() and same_t,
               (tag, "finite, JAX's times"))
        _check(builds == [tuple(b) for b in dfx[f"b5_{tag}_shapes"]],
               (tag, "window budgets", builds))
        _check(launches > 0 and sum(k2_by.values()) == launches,
               (tag, "K2 launches", launches))
        return res, routes, k2_by, biggest, d

    res_a, routes_a, _, _, d_a = run("policy", {})
    res_b, routes_b, k2_b, big_b, d_b = run("forced", {},
                                            shard_min_knots=0)
    res_c, routes_c, _, _, d_c = run("marg", dict(marginalize=True),
                                     shard_min_knots=0)
    # every knot within 1e-6 km: the card reads 1.4e-9 (one shard) and
    # 7.4e-9 km (eight), the CPU 9.1e-10 / 7.1e-9
    for tag, d, res in (("policy", d_a, res_a), ("forced", d_b, res_b),
                        ("marg", d_c, res_c)):
        f_j = float(dfx[f"b5_{tag}_errors"][-1])
        _check(d <= 1e-6 and abs(res.errors[-1] - f_j) <= 0.01,
               ("5(b) vs JAX", tag, d, res.errors[-1]))
    _check(set(routes_a) == {"1x1"} and set(routes_b) == {f"1x{n_arc}"}
           and set(routes_c) == {f"1x{n_arc}"},
           ("5(b) routes", routes_a, routes_b, routes_c))
    d_not4 = sorted({k[2] for k in k2_b if k[2] != 4})
    print(f"5(b): K2 ran at D = {d_not4} (not 4) on the forced run")
    _check(d_not4, ("K2 at D != 4", dict(k2_b)))

    with _deterministic():
        res_f, _, k2_f, big_f, d_f = run("f32", dict(dtype="float32"),
                                         shard_min_knots=0)
    f_j32, f_b = float(dfx["b5_f32_errors"][-1]), float(res_b.errors[-1])
    k2_f32 = sum(c for k, c in k2_f.items() if k[0] == "float32")
    print(f"5(b) f32: final {res_f.errors[-1]:.6f} km, JAX's f32 "
          f"{f_j32:.6f}, the f64 run (b) {f_b:.6f}; per-knot max |d| vs "
          f"JAX's f32 {d_f:.3e} km; K2 launches in f32 {k2_f32}")
    # JAX's f32 run: every knot within 0.01 km (the card reads 4.97e-3),
    # the final within 0.01 km (reads 8.1e-4).  The f64 run: the final
    # within 0.05 km, since the last window's best iterate is a near tie in
    # f32 (residuals 4e-4 apart, final knots 0.044 km apart; a 1e-6 px
    # change of the rows moves JAX's and the port's runs between the two)
    _check(d_f <= 0.01 and abs(res_f.errors[-1] - f_j32) <= 0.01
           and abs(res_f.errors[-1] - f_b) <= 0.05 and k2_f32 > 0,
           ("5(b) f32", d_f, res_f.errors[-1], f_j32, f_b, k2_f32))
    out["launches"]["f32_in_f32"] = k2_f32

    # K2 at each run's largest (N, D), beside the two einsums
    out["shape"] = _k2_at_shape(*big_b, 1e-12, "5(b)'s largest window", smi)
    out["shape_f32"] = _k2_at_shape(*big_f, 1e-5,
                                    "5(b)'s largest window in f32", smi)
    return out


def _k2_at_shape(J, r, w, tol: float, what: str, smi: str) -> dict:
    """K2 on one recorded (J, r, w) against its plain twin (relative
    `tol`), timed in turns with the twin, beside the two einsums and its
    bound: prints the `K2 time` line and returns the shape's record."""
    import torch
    from vinsat_tpu_torch.kernels import normal_eq

    k2 = normal_eq.assemble_normal_eq
    plain = normal_eq.assemble_normal_eq_plain
    N, D = J.shape[:2]
    dtype = str(J.dtype)[6:]
    G, g = k2(J, r, w)
    G_p, g_p = plain(J, r, w)
    torch.cuda.synchronize()
    err = max(float((G - G_p).abs().max() / G_p.abs().max()),
              float((g - g_p).abs().max() / g_p.abs().max()))
    ms, plain_ms, rd = _alternate(lambda: plain(J, r, w),
                                  lambda: k2(J, r, w))
    JW = J * w[..., None, None]
    lib_ms = _time_ms(lambda: (torch.einsum("ndki,ndkj->nij", JW, J),
                               torch.einsum("ndki,ndk->ni", JW, r)))
    # per row: 9 products J w, then 45 + 9 FMAs (G's upper triangle, g)
    bound = _bound_ms(N * 2 * D * (9 + 2 * 54),
                      PEAK_F64 if dtype == "float64" else PEAK_F32,
                      J.element_size() * (J.numel() + r.numel() + w.numel()
                                          + N * 90))
    print(f"K2 time N={N} D={D} {dtype} ({what}): kernel {ms:.4f} ms "
          f"({rd[1]:.4f}, {rd[2]:.4f}), plain {plain_ms:.4f} ms "
          f"({rd[0]:.4f}, {rd[3]:.4f}), the two einsums {lib_ms:.4f} ms, "
          f"bound {bound[0]:.6f} ms ({bound[1]}); rel err vs plain "
          f"{err:.3e}  [{smi}]")
    _check(err <= tol, ("K2", what, err))
    return {"N": N, "D": D, "dtype": dtype, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib_ms,
            "max_rel_err": err}


def _phase19(dev, smi, seqs4) -> dict:
    """19. Configs 4, 5(a) and 2 in f32 on the card from JAX's data
    (`seqs4`: config 4's 8 sequences, from JAX's draws); returns K1's and
    K2's launches and K1's timing at (8, 768) in f32."""
    import numpy as np
    import torch
    from vinsat_tpu_torch import pipeline, run_configs
    from vinsat_tpu_torch.dist import long_arc, mesh, sharded_ba
    from vinsat_tpu_torch.estimation import window
    from vinsat_tpu_torch.kernels import normal_eq, tridiag_pcr

    dfx, c4 = np.load(DIST_FIXTURE), np.load(CONST_FIXTURE)
    la_fx, md = np.load(LONGARC_FIXTURE), np.load(MODES_FIXTURE)
    solve = tridiag_pcr.block_tridiag_solve_pcr
    k2 = normal_eq.assemble_normal_eq
    cfg32 = window.StreamingConfig(dtype="float32")
    out = {}

    # config 4 in f32: every K1 launch at (B, n_pad) in f32
    k1_by, k1_last = collections.Counter(), []

    def on_launch(D, U, b):
        k1_by[(str(D.dtype)[6:], D.shape[0], D.shape[1])] += 1
        k1_last[:] = [a.clone() for a in (D, U, b)]

    solve.launches = 0
    seeds4 = [int(v) for v in c4["seeds"]]
    with _k1_recording(on_launch):
        r4 = pipeline.constellation_from_sequences(
            seeds4, seqs4, json.loads(str(c4["sim_kwargs"]))["duration_s"],
            int(c4["num_iters"]), int(c4["init_iters"]), cfg32, device=dev)
    med = np.array(r4["median_errors_km"])
    d32 = np.abs(med - dfx["c4_f32_median_errors_km"])
    d64 = np.abs(med - c4["median_errors_km"])
    print(f"config 4 f32: medians " + ", ".join(f"{e:.6f}" for e in med)
          + f" km; max |d| vs JAX f32 {d32.max():.3e}, vs JAX f64 "
          f"{d64.max():.3e} km; solve wall {r4['wall_s']:.2f} s; K1 "
          f"launches {solve.launches} by (dtype, B, N): "
          + ", ".join(f"{k[0]} {k[1]}x{k[2]}: {c}"
                      for k, c in sorted(k1_by.items())) + f"  [{smi}]")
    # f32 against f32 within 0.01 km; against f64 within 0.02 km (JAX's
    # own f32 medians lie up to 0.005 km from its f64 ones, and K1's f32
    # PCR rounds apart from JAX's CPU f32 solve)
    d_jj = np.abs(dfx["c4_f32_median_errors_km"] - c4["median_errors_km"])
    print(f"config 4 f32: JAX's own f32 medians lie up to {d_jj.max():.3e} "
          f"km from its f64 ones")
    _check(r4["orbit_seeds"] == dfx["c4_f32_seeds"].tolist()
           and d32.max() <= 0.01 and d64.max() <= 0.02,
           ("config 4 f32", med.tolist()))
    _check(solve.launches > 0 and set(k1_by) == {
        ("float32", len(seeds4), int(c4["n_pad"]))},
        ("config 4 f32 K1", dict(k1_by)))
    out["k1_config4_f32"] = solve.launches
    out["k1_shape"] = _k1_at_shape(*k1_last, PEAK_F32,
                                   "config 4 f32, the run's last system", smi)

    # config 5(a) in f32: 20 K2 launches in f32
    k2_dt = collections.Counter()

    def on_k2(assemble, J, r, w, f32=False):
        k2_dt[str(J.dtype)[6:]] += 1
        return assemble(J, r, w, f32=f32)

    prob, gt, kt, n_real = long_arc.build_sharded_problem(
        la_fx, n_arc=int(la_fx["n_arc"]), dtype=torch.float32, device=dev,
        **json.loads(str(la_fx["problem_kwargs"])))
    k2.launches = 0
    t0 = time.time()
    with _patched(sharded_ba, "assemble_normal_eq", on_k2):
        res5 = long_arc.solve_long_arc(
            mesh.make_mesh(1, int(la_fx["n_arc"]), device=dev), prob, gt, kt,
            n_real, **json.loads(str(la_fx["solve_kwargs"])))
    wall5 = time.time() - t0
    med5, med5_j = (float(np.median(res5.errors_km)),
                    float(np.median(dfx["c5a_f32_errors_km"])))
    print(f"config 5(a) f32: median {med5:.6f} km (JAX f32 {med5_j:.6f}, "
          f"f64 {float(np.median(la_fx['errors_km'])):.6f}), {wall5:.2f} s, "
          f"K2 launches {k2.launches} by dtype {dict(k2_dt)}  [{smi}]")
    _check(np.isfinite(res5.states).all() and abs(med5 - med5_j) <= 0.01,
           ("config 5(a) f32", med5, med5_j))
    _check(k2.launches == 20 and k2_dt == {"float32": 20},
           ("config 5(a) f32 K2", k2.launches, dict(k2_dt)))
    out["k2_longarc_f32"] = k2.launches

    # config 2 in f32
    solve.launches = 0
    k1_by.clear()
    seq12 = {"det_rows": md["det_rows_12"],
             "orbit_pos_eci_km": md["orbit_pos_eci_km_12"]}
    with _k1_recording(on_launch):
        r2 = run_configs.run_fullbatch(3600, seq=seq12, dtype="float32",
                                       device=dev)
    med2_j = float(np.median(dfx["c2_f32_errors"]))
    print(f"config 2 f32: median {r2['median_error_km']:.6f} km (JAX f32 "
          f"{med2_j:.6f}, f64 {float(np.median(md['c2_errors'])):.6f}), "
          f"{r2['wall_s']:.2f} s, K1 launches {solve.launches}  [{smi}]")
    _check(abs(r2["median_error_km"] - med2_j) <= 0.01
           and set(k1_by) == {("float32", 1, 768)}, ("config 2 f32", r2,
                                                     dict(k1_by)))
    out["k1_config2_f32"] = solve.launches
    out["k1_shape2"] = _k1_at_shape(*k1_last, PEAK_F32,
                                    "config 2 f32, the run's last system",
                                    smi)
    return out


def _ok_fields(line: str) -> dict:
    """The key=value fields of a launcher worker's OK line."""
    return dict(tok.split("=", 1) for tok in line.split() if "=" in tok)


def _spawned(num_processes: int, local: int, program: str,
             env=None) -> list:
    """dist/launch.spawn of `program` on the card(s), `env` added to the
    workers' environment; every worker's OK line, parsed, after checking
    that the run passed (the workers hold their rank run against the
    one-process layout themselves)."""
    import io

    from vinsat_tpu_torch.dist import launch

    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = launch.spawn(num_processes, local, program, timeout_s=600,
                          device="cuda", env=env)
    wall = time.time() - t0
    text = buf.getvalue()
    oks = [ln for ln in text.splitlines() if ln.startswith(f"{program} OK")]
    if rc != 0 or len(oks) != num_processes:
        print(text)
    _check(rc == 0 and len(oks) == num_processes,
           (program, num_processes, local, rc, len(oks)))
    rows = []
    for ln in oks:
        f = _ok_fields(ln)
        f["rank"] = ln.split("rank ", 1)[1].split()[0]
        rows.append(f)
        print(f"  {program} rank {f['rank']}: backend {f['backend']}, "
              f"device {f['device']}, wall {f['wall_s']} s (one process "
              f"{f['one_process_wall_s']} s)"
              + "".join(f", {k} {f[k]}" for k in (
                  "K2_launches", "K3_launches", "rel_vs_one_process",
                  "max_knot_diff_vs_one_process", "local_median_err",
                  "sim_wall_s") if k in f))
    print(f"spawn {num_processes} x {local} {program}: {wall:.1f} s")
    return rows


def _phase20(dev, smi) -> dict:
    """20. The arc shards on torch.distributed ranks: the launcher's three
    programs at 2 processes x 2 shards on this card (gloo, the ranks
    sharing it), at one rank a card over nccl where there are two cards or
    more, then bench_scaling's rows and dispatch scan (f32)."""
    import torch
    from vinsat_tpu_torch.dist import bench_scaling

    out = {"runs": {}}
    for program in ("selftest", "ba-step", "stream"):
        # the two ranks share the first card on any host, so gloo
        rows = _spawned(2, 2, program, env={"CUDA_VISIBLE_DEVICES": "0"})
        _check(all(r["backend"] == "gloo" and r["device"] == "cuda:0"
                   for r in rows), (program, rows))
        out["runs"][program] = rows
    k2 = {p: [int(r["K2_launches"]) for r in out["runs"][p]]
          for p in ("ba-step", "stream")}
    k3 = [int(r["K3_launches"]) for r in out["runs"]["stream"]]
    # one LM iteration; the stream's run-to-max chain of 16
    _check(k2["ba-step"] == [1, 1] and k2["stream"] == [16, 16]
           and k3 == [1, 1], ("launches on the ranks", k2, k3))
    out["k2"], out["k3"] = k2, k3
    cards = torch.cuda.device_count()
    if cards >= 2:
        for program in ("selftest", "ba-step", "stream"):
            rows = _spawned(cards, 1, program)
            _check(all(r["backend"] == "nccl"
                       and r["device"] == f"cuda:{r['rank'].split('/')[0]}"
                       for r in rows), rows)
            out["runs"][f"{program}_nccl"] = rows
    else:
        print(f"nccl, one rank a card: not run ({cards} card)")

    t0 = time.time()
    out["overhead"] = [dict(r, base_knots=bk) for bk in (64, 256)
                       for r in bench_scaling.overhead_rows(
                           bk, repeats=3, device=dev)]
    out["scan"] = bench_scaling.dispatch_scan(repeats=3, device=dev)
    print(json.dumps(bench_scaling.device_row(dev)))
    for r in out["overhead"] + out["scan"]:
        print("  bench_scaling " + json.dumps(r))
    out["crossover"] = next((r["window_knots"] for r in out["scan"]
                             if r["shard_wins"]), None)
    print(f"bench_scaling: dispatch crossover {out['crossover']} knots (the "
          f"stream's default stays 256), {time.time() - t0:.1f} s  [{smi}]")
    return out


def _phase21(dev, smi, orbit_step_us: float) -> dict:
    """21. The hi-fi truth from JAX's draws (tests/data/
    torch_hifi_seed1.npz) and the constellation's batched rollout."""
    import numpy as np
    import torch
    from vinsat_tpu_torch import pipeline
    from vinsat_tpu_torch.core import dynamics
    from vinsat_tpu_torch.evalx import ate
    from vinsat_tpu_torch.kernels import tridiag_pcr, visible_count
    from vinsat_tpu_torch.sim import orbits

    hfx = np.load(HIFI_FIXTURE)
    kw = json.loads(str(hfx["sim_kwargs_h"]))
    k3 = visible_count.visible_count
    k1 = tridiag_pcr.block_tridiag_solve_pcr
    out = {}
    k3.launches = 0
    t0 = time.time()
    seq = pipeline.simulate_from_draws(_fixture_draws(hfx, "h"), device=dev,
                                       **kw)
    wall = time.time() - t0
    out["k3"] = k3.launches
    d_pos = float(np.abs(seq.orbit_pos_eci_km - hfx["pos_eci_h"]).max())
    d_vel = float(np.abs(seq.traj.vel_eci.cpu().numpy()
                         - hfx["vel_eci_h"]).max())
    print(f"hi-fi arc: {len(seq.orbit_pos_eci_km)} s, wall {wall:.2f} s, "
          f"max |d pos_eci| vs JAX (every second) {d_pos:.3e} km, |d vel| "
          f"{d_vel:.3e} km/s, K3 launches {k3.launches}  [{smi}]")
    # an H100 reads 1.0e-11 km here, eager or graphed
    _check(d_pos <= 1e-10, ("hi-fi trajectory", d_pos))
    _rows_check("hi-fi arc", seq.det_rows, hfx["det_rows_h"], 1e-9)
    _check(np.array_equal(seq.dets.frame_visible.cpu().numpy(),
                          hfx["frame_visible_h"]), "hi-fi gate")
    _check(k3.launches == 1, ("K3 in the hi-fi simulation", k3.launches))

    # the cost of a hi-fi step beside the reference model's (phase 7)
    x0 = torch.cat([seq.traj.pos_eci[0], seq.traj.vel_eci[0]])
    torch.cuda.synchronize()
    t0 = time.time()
    dynamics.rollout_orbit_hifi(x0, 1000, 1.0)
    torch.cuda.synchronize()
    out["step_us"] = (time.time() - t0) / 1000 * 1e6
    print(f"hi-fi orbit RK4 step {out['step_us']:.1f} µs, the reference "
          f"model's {orbit_step_us:.1f} µs (phase 7; 1000-step chains, "
          f"each a captured step replayed)  [{smi}]")

    # the arc streamed: the estimator keeps two-body + J2
    k1.launches = 0
    t0 = time.time()
    res = pipeline.run_streaming(seq, seed=int(hfx["seed"]), device=dev)
    wall_s = time.time() - t0
    final = float(res.errors[-1])
    out["k1"] = k1.launches
    print(f"hi-fi arc streamed: {len(res.errors)} errors, time_to_5km_s "
          f"{ate.time_to_threshold(res.errors, res.times, 5.0)}, "
          f"final_error_km {final:.6f}, {wall_s:.2f} s, K1 launches "
          f"{k1.launches}  [{smi}]")
    _check(np.isfinite(res.errors).all() and final < 5.0,
           ("hi-fi stream", final))

    # generate_constellation: 8 orbits x 600 s as one batched rollout
    torch.cuda.synchronize()
    t0 = time.time()
    con = orbits.generate_constellation(torch.Generator().manual_seed(0), 8,
                                        duration_s=600, device=dev)
    torch.cuda.synchronize()
    wall_b = time.time() - t0
    g = torch.Generator().manual_seed(0)
    err, t0 = 0.0, time.time()
    for b in range(8):
        one = orbits.generate_trajectory(g, duration_s=600, device=dev)
        for name in orbits.Trajectory._fields:
            a, w = getattr(con, name)[b], getattr(one, name)
            err = max(err, float((a - w).abs().max() / w.abs().max()))
    torch.cuda.synchronize()
    wall_1 = time.time() - t0
    print(f"generate_constellation 8 x 600 s: batched {wall_b:.2f} s, one "
          f"at a time {wall_1:.2f} s, max rel diff {err:.3e}  [{smi}]")
    _check(tuple(con.pos_eci.shape) == (8, 601, 3) and err <= 1e-12,
           ("constellation", tuple(con.pos_eci.shape), err))
    return out


def _imagery_case(fx, case):
    """(draws, rasters, kwargs) of one case of the imagery fixture."""
    import numpy as np
    import torch
    from vinsat_tpu_torch import pipeline
    from vinsat_tpu_torch.sim import orbits

    g = lambda k: fx[f"{k}_{case}"]  # noqa: E731
    draws = pipeline.ImageryDraws(
        orbits.OrbitalElements(*(float(v) for v in g("oe"))),
        np.asarray(g("q0")), np.asarray(g("w0")), int(g("db_seed")),
        torch.as_tensor(g("templates")))
    rasters = [g(f"raster{i}") for i in range(len(g("affine")))]
    return draws, rasters, json.loads(str(g("kwargs")))


@contextlib.contextmanager
def _tf32_recording(seen):
    """Inside the block every F.conv2d, F.linear and torch.einsum call made
    within the imagery path's detection stage (pipeline.detect_crops)
    appends the TF32 flags (cuDNN, cuBLAS) it ran under to `seen`."""
    import torch
    import torch.nn.functional as F
    from vinsat_tpu_torch import pipeline

    inside = [False]

    def stage(orig, *a, **kw):
        inside[0] = True
        try:
            return orig(*a, **kw)
        finally:
            inside[0] = False

    def hook(orig, *a, **kw):
        if inside[0]:
            seen.append((torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
        return orig(*a, **kw)

    with _patched(pipeline, "detect_crops", stage), \
            _patched(F, "conv2d", hook), _patched(F, "linear", hook), \
            _patched(torch, "einsum", hook):
        yield


def _row_px_err(seq):
    """Pixel error of the rows the stream keeps (confidence above its 0.8
    gate) against their landmark's true pixel (the class lon / lat
    projected into the frame's nadir camera, f64): (median, 95th
    percentile, max, rows over the reference's 10 px gate, rows kept).
    Below the gate the PatchCNN's top proposal for a class absent from a
    crop is a false row, far from its landmark."""
    import numpy as np
    import torch
    from vinsat_tpu_torch.sim import camera

    d = seq.det_rows[seq.det_rows[:, 5] > 0.8]
    if not len(d):
        return (np.nan,) * 3 + (0, 0)
    dev = seq.traj.pos_ecef.device
    fr = torch.as_tensor(d[:, 0].astype(np.int64), device=dev)
    lon, lat = (torch.as_tensor(d[:, i], device=dev)[:, None] for i in (1, 2))
    uv, _ = camera.lonlat_to_pixel(
        camera.CameraModel.from_hfov(),
        camera.CameraPose.nadir(seq.traj.pos_ecef[fr] * 1000.0), lon, lat)
    e = np.hypot(*(uv[:, 0].cpu().numpy() - d[:, 3:5]).T)
    return (float(np.median(e)), float(np.percentile(e, 95)), float(e.max()),
            int((e > 10.0).sum()), len(d))


def _imagery_run(tag, dev, smi, sim, stream_seed=1):
    """sim() (an imagery simulation on the card, TF32 recorded), then its
    rows streamed: prints the stages' seconds, µs a crop, the peak device
    memory and the stream; returns (seq, result, K1 launches, TF32 flags
    seen)."""
    import numpy as np
    import torch
    from vinsat_tpu_torch import pipeline
    from vinsat_tpu_torch.evalx import ate
    from vinsat_tpu_torch.kernels import tridiag_pcr

    k1 = tridiag_pcr.block_tridiag_solve_pcr
    seen = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with _tf32_recording(seen):
        seq = sim()
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    k1.launches = 0
    t0 = time.time()
    res = pipeline.run_streaming(seq, seed=stream_seed, device=dev)
    wall_s = time.time() - t0
    launches = k1.launches
    c = seq.crops
    n_crops = 0 if c is None else len(c.frames)
    st = dict(seq.stage_s, stream=wall_s)
    det_us = 1e6 * st.get("detection", 0.0) / max(n_crops, 1)
    px = _row_px_err(seq)
    e_min, e_fin = ((float(np.min(res.errors)), float(res.errors[-1]))
                    if len(res.errors) else (float("nan"),) * 2)
    print(f"{tag}: {len(seq.det_rows)} rows from {n_crops} crops "
          f"{None if c is None else c.crop_hw}, simulation {wall:.2f} s ("
          + ", ".join(f"{k} {v:.3f} s" for k, v in st.items())
          + f"), detection {det_us:.1f} µs a crop, pixel error of the "
          f"{px[4]} rows over conf 0.8: median {px[0]:.3f} / 95% "
          f"{px[1]:.3f} / max {px[2]:.3f} px, {px[3]} over 10 px, peak "
          f"device memory "
          f"{peak:.1f} MiB; stream {len(res.errors)} errors, min "
          f"{e_min:.6f} km, final {e_fin:.6f} km, time_to_5km_s "
          f"{ate.time_to_threshold(res.errors, res.times, 5.0)}, K1 launches "
          f"{launches}  [{smi}]")
    _check(len(seen) > 0 and not any(a or b for a, b in seen),
           (tag, "TF32 inside the detection", seen[:4]))
    return seq, res, launches, det_us, px


def _phase22(dev, smi) -> dict:
    """22. The imagery path: the fixture's two JAX runs replayed on the
    card and held to JAX's detections, rows and stream; the port's own
    arcs with both detectors."""
    import numpy as np
    import torch
    from vinsat_tpu_torch import pipeline
    from vinsat_tpu_torch.sim import learned_detector as ld

    fx = np.load(IMAGERY_FIXTURE)
    det = ld.load_detector(DETECTOR_FIXTURE, device=dev)
    out = {"k1": {}}
    for case, tag, gate in (("a", "NCC", 0.55), ("b", "PatchCNN", 0.5)):
        draws, rasters, kw = _imagery_case(fx, case)
        detector = det if case == "b" else None
        seq, res, k1n, _, _ = _imagery_run(
            f"imagery fixture {case} ({tag})", dev, smi,
            lambda: pipeline.simulate_imagery_from_draws(
                draws, rasters=rasters, detector=detector, device=dev, **kw))
        out["k1"][f"fixture_{case}"] = k1n
        c = seq.crops
        win = fx[f"win_{case}"]
        want = fx[f"scores_{case}"]
        on = want > (0.3 if case == "a" else 0.0)
        d_s = float(np.abs(c.scores - want).max()) if c.scores.shape == \
            want.shape else np.inf
        d_p = max(float(np.abs(getattr(c, k)[on] - fx[f"{k}_{case}"][on])
                        .max()) for k in ("rows", "cols")) \
            if np.isfinite(d_s) else np.inf
        rows, want_rows = seq.det_rows, fx[f"det_rows_{case}"]
        same = rows.shape == want_rows.shape
        d_ll = float(np.abs(rows[:, 1:3] - want_rows[:, 1:3]).max()) \
            if same else np.inf
        d_uv = float(np.abs(rows[:, 3:5] - want_rows[:, 3:5]).max()) \
            if same else np.inf
        d_c = float(np.abs(rows[:, 5] - want_rows[:, 5]).max()) \
            if same else np.inf
        d_e = float(np.abs(res.errors - fx[f"errors_{case}"]).max()) \
            if len(res.errors) == len(fx[f"errors_{case}"]) else np.inf
        # JAX's own rows through the port's stream on the card
        res_j = pipeline.run_streaming(
            {"det_rows": want_rows, "orbit_pos_eci_km": seq.orbit_pos_eci_km},
            seed=1, device=dev)
        d_j = float(np.abs(res_j.errors - fx[f"errors_{case}"]).max()) \
            if len(res_j.errors) == len(fx[f"errors_{case}"]) else np.inf
        d_w = float(np.abs(c.windows[:, [2, 5]] - win[:, 1:3]).max())
        margin = float(np.abs(want[on] - gate).min())
        print(f"imagery fixture {case} vs JAX: crop windows' origins "
              f"within {d_w:.3e} deg, "
              f"max |d score| {d_s:.3e}, max |d row/col| {d_p:.3e} px "
              f"(score > {0.3 if case == 'a' else 0.0}), rows "
              f"{len(rows)} (JAX {len(want_rows)}), max |d lon/lat| "
              f"{d_ll:.3e} deg, |d uv| {d_uv:.3e} px, |d conf| {d_c:.3e}, "
              f"stream |d error| {d_e:.3e} km, JAX's rows streamed "
              f"{d_j:.3e} km (JAX final "
              f"{float(fx[f'errors_{case}'][-1]):.6f}); JAX's nearest "
              f"score to the gate {margin:.3e} away")
        _check(d_w <= 1e-9 and np.array_equal(c.shapes, win[:, 3:5])
               and c.crop_hw == tuple(fx[f"crop_hw_{case}"]),
               (case, "crops"))
        _check(margin > 1e-4 and d_s <= 1e-5 and d_p <= 1e-3,
               (case, "detections", margin, d_s, d_p))
        _check(same and np.array_equal(rows[:, 0], want_rows[:, 0])
               and d_ll <= 1e-9 and d_uv <= 1e-3 and d_c <= 1e-5,
               (case, "rows", d_ll, d_uv, d_c))
        # the rows' f32 sub-pixel differences (<= 2e-4 px on the card)
        # move this 600 s one-window estimate by a few 1e-6 km: the port's
        # rows are held at 1e-4 km, JAX's rows through the port at 1e-6
        _check(np.array_equal(res.times, fx[f"times_{case}"])
               and d_e <= 1e-4 and d_j <= 1e-6, (case, "stream", d_e, d_j))

    # the detection stage alone under the profiler: case b's crops (the
    # CNN) and case a's (the NCC)
    for case, detector in (("a", None), ("b", det)):
        draws, rasters, kw = _imagery_case(fx, case)
        scene = pipeline._imagery_scene(
            draws, kw["duration_s"], kw["frame_stride"],
            kw.get("num_landmarks", 60), 0.01, 1.5, 12.0, rasters, dev, {})
        Hc, Wc = pipeline.detect_crops(detector, scene.crops,
                                       scene.templates)[3]
        wall, per = _device_profile(lambda: pipeline.detect_crops(
            detector, scene.crops, scene.templates))
        busy = sum(t for _, t in per.values()) * 1e-6
        top = sorted(per.items(), key=lambda kv: -kv[1][1])[:3]
        n = len(scene.crops)
        patches = n * ((Hc - 12) // 2 + 1) * ((Wc - 12) // 2 + 1)
        extra = (f", {patches / wall:.4g} patches/s of the CNN"
                 if detector is not None else "")
        print(f"imagery detection alone, fixture {case}: {n} crops in "
              f"{1e3 * wall:.2f} ms ({1e6 * wall / n:.1f} µs a crop{extra}),"
              f" device busy {1e3 * busy:.2f} ms "
              f"({100 * busy / wall:.1f}%); top kernels "
              + "; ".join(f"{k[:60]} x{c} {t / 1e3:.2f} ms"
                          for k, (c, t) in top) + f"  [{smi}]")
        out[f"busy_{case}"] = busy / wall if per else None

    # the port's own arcs: the entry point's defaults, the CLI's 10800 s
    # arc, the PatchCNN on 1800 s (their windows hold < 49 knots: Thomas,
    # no K1), then one arc a detector dense enough for windows of > 48
    # knots, which the stream solves through K1
    _, res, k1n, _, _ = _imagery_run(
        "imagery own seed 1 (600 s, stride 30, NCC)", dev, smi,
        lambda: pipeline.simulate_sequence_imagery(1, device=dev))
    _check(len(res.errors) and np.isfinite(res.errors).all(),
           ("own 600 s", res.errors))
    out["k1"]["own_600"] = k1n
    seq, res, k1n, _, _ = _imagery_run(
        "imagery own seed 1 (10800 s, stride 30, NCC)", dev, smi,
        lambda: pipeline.simulate_sequence_imagery(
            1, duration_s=10800, frame_stride=30, device=dev))
    _check(len(res.errors) and float(res.errors[-1]) < 5.0,
           ("own 10800 s final", res.errors[-1:]))
    out["k1"]["own_10800"] = k1n
    seq, res, k1n, det_us, _ = _imagery_run(
        "imagery own seed 1 (1800 s, stride 30, PatchCNN)", dev, smi,
        lambda: pipeline.simulate_sequence_imagery(
            1, duration_s=1800, frame_stride=30, num_landmarks=10,
            templates=fx["templates_b"], detector=det, conf_threshold=0.5,
            device=dev))
    _check(len(res.errors) and float(res.errors.min()) < 5.0,
           ("own 1800 s PatchCNN min", res.errors))
    out["k1"]["own_1800_learned"] = k1n
    n_grid = ((seq.crops.crop_hw[0] - 12) // 2 + 1) * (
        (seq.crops.crop_hw[1] - 12) // 2 + 1)
    print(f"PatchCNN on the 1800 s arc: {n_grid} patches a crop, "
          f"{n_grid / (det_us * 1e-6):.4g} patches/s through the detection "
          f"stage  [{smi}]")
    # K1's imagery paths.  The PatchCNN's 10 classes give a 600 s arc of
    # 10 landmarks, whose one-window estimate ends ~4-5 km off with any
    # detector (the NCC detector on the same arc: 5.43 km at rows within
    # 4.3 px): the rows it keeps are held to the reference's 10 px gate
    for key, tag, kw in (
            ("imagery_stream", "1800 s, stride 10, NCC",
             dict(duration_s=1800, frame_stride=10)),
            ("imagery_learned_stream", "600 s, stride 1, PatchCNN",
             dict(duration_s=600, frame_stride=1, num_landmarks=10,
                  templates=fx["templates_b"], detector=det,
                  conf_threshold=0.5))):
        _, res, k1n, _, px = _imagery_run(
            f"imagery own seed 1 ({tag})", dev, smi,
            lambda: pipeline.simulate_sequence_imagery(1, device=dev, **kw))
        _check(len(res.errors) and np.isfinite(res.errors).all() and k1n > 0
               and px[0] < 10.0, (key, k1n, res.errors, px))
        if key == "imagery_stream":
            _check(float(res.errors.min()) < 5.0, (key, res.errors))
        out["k1"][key] = k1n
    return out


T_START = time.time()


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from vinsat_tpu_torch import pipeline, run_configs
    from vinsat_tpu_torch.core import dynamics
    from vinsat_tpu_torch.dist import long_arc, mesh
    from vinsat_tpu_torch.estimation import ba, ingest, refine, window
    from vinsat_tpu_torch.evalx import ate, crlb
    from vinsat_tpu_torch.kernels import (_build, matching, normal_eq,
                                          tridiag_pcr, visible_count)
    from vinsat_tpu_torch.sim import camera, detections, mgrs

    fx = np.load(STREAM_FIXTURE)
    sim_fx = np.load(SIM_FIXTURE)
    dev = torch.device("cuda")
    solve = tridiag_pcr.block_tridiag_solve_pcr
    plain = tridiag_pcr.block_tridiag_solve_pcr_plain
    k3 = visible_count.visible_count
    k3_plain = visible_count.visible_count_plain
    k2 = normal_eq.assemble_normal_eq
    k2_plain = normal_eq.assemble_normal_eq_plain
    la_fx = np.load(LONGARC_FIXTURE)

    phase_t = [time.time()]

    def phase_done(n: int) -> None:
        now = time.time()
        print(f"phase {n}: {now - phase_t[0]:.1f} s")
        phase_t[0] = now

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = _smi()
    print(f"device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    print(f"nvidia-smi: {smi}")

    phase_done(1)

    # 2. build every kernel at once
    kernels = ("tridiag_pcr", "normal_eq", "visible_count")
    t0 = time.time()
    with ThreadPoolExecutor(len(kernels)) as pool:
        for f in [pool.submit(_build.load, n) for n in kernels]:
            f.result()
    print(f"build: {' + '.join(kernels)} in {time.time() - t0:.2f} s")
    for n in kernels:
        for line in _build.build_logs.get(n, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {n}: {line.strip()}")
    print(f"K1 resident warps (one cooperative grid): "
          f"{tridiag_pcr.resident_warps(torch.float64)} in f64, "
          f"{tridiag_pcr.resident_warps(torch.float32)} in f32")

    phase_done(2)

    # 3. K1 against its plain twin (and Thomas) on the card
    rng = np.random.default_rng(0)
    k1_err = 0.0
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
                k1_err = max(k1_err, float((x - xp).abs().max()))
                xt = ba.block_tridiag_solve(Dc, Uc, bc)
                err_t = float((x - xt).abs().max() / xt.abs().max())
                line += f", vs Thomas {err_t:.3e}"
                _check(err_t <= tol, (N, err_t))
            print(line)
            _check(np.isfinite(err) and err <= tol, (N, dtype, err))
    k1_rows = _k1_times(solve, plain, dev, smi)
    for key, row in k1_rows.items():
        _check(row[3] == 1, ("K1 device kernels per call", key, row[3]))
    k1_ms, k1_plain_ms, k1_bound, _ = k1_rows[(448, "float64")]
    D, U, b = (torch.as_tensor(a, device=dev)
               for a in _problem(rng, 9, 448))
    # the library yardstick: torch.linalg.solve on the dense systems,
    # through each of torch's linear-algebra backends; the faster counts
    A, rhs = _dense(D, U), b.reshape(9, -1, 1)
    x_dense = torch.linalg.solve(A, rhs)[..., 0]
    err_d = float((x_dense.reshape(b.shape) - solve(D, U, b)).abs().max()
                  / x_dense.abs().max())
    lib = {}
    for backend in ("cusolver", "magma"):
        torch.backends.cuda.preferred_linalg_library(backend)
        lib[backend] = _time_ms(lambda: torch.linalg.solve(A, rhs), reps=3)
    torch.backends.cuda.preferred_linalg_library("default")
    k1_lib_ms = min(lib.values())
    del A
    print(f"K1 N=448 B=9 f64: kernel {k1_ms:.4f} ms, plain "
          f"{k1_plain_ms:.4f} ms, "
          f"dense torch.linalg.solve {lib['cusolver']:.4f} ms (cusolver) / "
          f"{lib['magma']:.4f} ms (magma) (rel diff {err_d:.2e}), bound "
          f"{k1_bound[0]:.4f} ms ({k1_bound[1]})  "
          f"[{smi}]")

    phase_done(3)

    # 4. the streaming slice on the card
    seed = int(fx["seed"])
    cfg = window.StreamingConfig(dtype="float64")

    def n_windows(det, orbit, s):
        prep = window.prepare_stream(det, orbit, s, cfg, device=dev)
        return prep, len(ingest.split_windows(prep.graph.ii, prep.knot_t))

    det, orbit = pipeline.stream_inputs(fx)
    prep, nw = n_windows(det, orbit, seed)
    solve.launches = k3.launches = 0
    k1_shapes = collections.Counter()
    t0 = time.time()
    with _k1_recording(
            lambda D, U, b: k1_shapes.update([tuple(D.shape[:2])])):
        res = pipeline.run_streaming(fx, seed=seed, cfg=cfg, device=dev)
    cold = time.time() - t0
    k1_launches = solve.launches
    walls = []
    for _ in range(1):
        t0 = time.time()
        res = pipeline.run_streaming(fx, seed=seed, cfg=cfg, device=dev)
        walls.append(time.time() - t0)
    t5 = ate.time_to_threshold(res.errors, res.times, 5.0)
    final = float(res.errors[-1])
    ref_final = float(fx["final_error_km"])
    ref_t5 = float(fx["time_to_5km_s"])
    print(f"stream: {nw} windows, {len(res.errors)} errors, "
          f"time_to_5km_s {t5} (JAX {ref_t5}), "
          f"final_error_km {final:.6f} (JAX {ref_final:.6f}), "
          f"recovery_trips {res.recovery_trips}")
    _check(np.isfinite(res.errors).all()
           and np.isfinite(res.final_states).all(), "finite results")
    _check(nw == int(fx["num_windows"]) == 7, nw)
    _check(t5 == ref_t5, t5)
    _check(abs(final - ref_final) <= 0.01, (final, ref_final))
    _check(len(res.errors) == len(fx["errors"]), len(res.errors))
    print(f"stream: max |d error| vs JAX "
          f"{np.abs(res.errors - fx['errors']).max():.3e} km")
    _check(k1_launches > 0, "K1 was not launched on the main path")
    print(f"stream: K1 launches {k1_launches}, by (B, N): "
          + ", ".join(f"{bn[0]}x{bn[1]}: {c}"
                      for bn, c in sorted(k1_shapes.items())))
    _check(sum(k1_shapes.values()) == k1_launches, k1_shapes)
    wall = min(walls)
    print(f"stream wall: cold {cold:.2f} s, timed "
          + " / ".join(f"{w:.2f} s" for w in walls)
          + f" -> {DURATION_S / wall:.1f} frames/s  [{smi}]")

    phase_done(4)

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

    phase_done(5)

    # 6. the simulator, mode a, from JAX's draws; then streamed
    kw_a = json.loads(str(sim_fx["sim_kwargs_a"]))
    k3.launches = 0
    t0 = time.time()
    seq_a = pipeline.simulate_from_draws(_fixture_draws(sim_fx, "a"),
                                         device=dev, **kw_a)
    wall_a = time.time() - t0
    print(f"sim a: {len(seq_a.orbit_pos_eci_km)} s arc, "
          f"{len(seq_a.dets.frame_visible)} frames, "
          f"{seq_a.db.num_landmarks} landmarks, wall {wall_a:.2f} s, K3 "
          f"launches {k3.launches}  [{smi}]")
    _rows_check("sim a", seq_a.det_rows, sim_fx["det_rows_a"], 1e-9)
    _check(len(seq_a.det_rows) == 3112, len(seq_a.det_rows))
    _check(np.array_equal(seq_a.dets.frame_visible.cpu().numpy(),
                          sim_fx["frame_visible_a"]), "gate a")
    d_pos = np.abs(seq_a.orbit_pos_eci_km[::100] - sim_fx["pos_eci_a"]).max()
    print(f"sim a: max |d pos_eci| vs JAX (every 100 s) {d_pos:.3e} km")
    _, nw_a = n_windows(*pipeline.stream_inputs(seq_a), seed)
    res_a = pipeline.run_streaming(seq_a, seed=seed, cfg=cfg, device=dev)
    t5_a = ate.time_to_threshold(res_a.errors, res_a.times, 5.0)
    final_a = float(res_a.errors[-1])
    print(f"sim a streamed: {nw_a} windows, time_to_5km_s {t5_a}, "
          f"final_error_km {final_a:.6f} (JAX {ref_final:.6f})")
    _check(nw_a == 7 and t5_a == 275.0 and abs(final_a - ref_final) <= 0.01,
           (nw_a, t5_a, final_a))

    phase_done(6)

    # 7. the simulator, mode b, from JAX's draws
    kw_b = json.loads(str(sim_fx["sim_kwargs_b"]))
    k3.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    seq_b = pipeline.simulate_from_draws(_fixture_draws(sim_fx, "b"),
                                         device=dev, **kw_b)
    wall_b = time.time() - t0
    n_frames = len(seq_b.dets.frame_visible)
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"sim b: {n_frames} frames, {seq_b.db.num_landmarks} landmarks, "
          f"{int(seq_b.dets.frame_visible.sum())} visible, wall "
          f"{wall_b:.2f} s -> {n_frames / wall_b:.1f} frames/s, peak "
          f"memory {peak:.1f} MiB, K3 launches {k3.launches}  [{smi}]")
    _check(k3.launches > 0, "K3 was not launched by the simulator")
    _check(np.array_equal(seq_b.dets.frame_visible.cpu().numpy(),
                          sim_fx["frame_visible_b"]), "gate b")
    _rows_check("sim b", seq_b.det_rows, sim_fx["det_rows_b"], 1e-9)
    # where a simulated arc's time goes: each rollout's cost per 1 Hz step,
    # and the detection stage (gate, projection, draws) alone
    tr = seq_b.traj
    step_us = {}
    for tag, fn, x0 in (
            ("orbit", dynamics.rollout_orbit,
             torch.cat([tr.pos_eci[0], tr.vel_eci[0]])),
            ("attitude", dynamics.rollout_attitude,
             torch.cat([tr.quat_body_eci[0], tr.omega_body[0]]))):
        torch.cuda.synchronize()
        t0 = time.time()
        fn(x0, 1000, 1.0)
        torch.cuda.synchronize()
        step_us[tag] = (time.time() - t0) * 1e3
    t0 = time.time()
    detections.generate_detections(
        _fixture_draws(sim_fx, "b").detection, tr, seq_b.db, conf_low=0.82)
    torch.cuda.synchronize()
    print(f"sim b stages: orbit rollout {step_us['orbit']:.1f} µs/step, "
          f"attitude rollout {step_us['attitude']:.1f} µs/step (1000-step "
          f"chains), detection stage {time.time() - t0:.3f} s  [{smi}]")

    phase_done(7)

    # 8. K3 against its plain twin at mode b's inputs: the landmarks region
    # by region, as the simulator gives them, and in a seeded random order
    # (where the tile cull skips almost nothing)
    cam = camera.CameraModel.from_hfov()
    pos_b = seq_b.traj.pos_ecef * 1000.0
    bounds, _ = camera.footprint_bounds(cam, camera.CameraPose.nadir(pos_b))
    db = seq_b.db
    accepted = db.best & mgrs.active_region_mask(dev)[db.region]
    F, L = bounds.shape[0], db.num_landmarks
    perm = torch.as_tensor(np.random.default_rng(8).permutation(L),
                           device=dev)
    per_pair, per_pair_src = _k3_compares(_build.load("visible_count")._name)
    print(f"K3 compare instructions a pair ({per_pair_src}): "
          + ", ".join(f"{t}: {a:g} (one box), {b:g} (lon and lon + 360)"
                      for t, (a, b) in per_pair.items()))
    k3_err, k3_times = 0, {}
    for order in ("regions", "shuffled"):
        for dtype, rate in ((torch.float64, INSTR_F64),
                            (torch.float32, INSTR_F32)):
            tag = str(dtype)[6:]
            lm = (db.lon, db.lat, accepted)
            if order == "shuffled":
                lm = tuple(a[perm] for a in lm)
            args = [bounds.to(dtype).contiguous(), lm[0].to(dtype),
                    lm[1].to(dtype), lm[2]]
            got, want = k3(*args), k3_plain(*args)
            torch.cuda.synchronize()
            k3_err = max(k3_err, int((got - want).abs().max()))
            _check(torch.equal(got, want), ("K3", order, dtype))
            if dtype == torch.float64:
                _check(np.array_equal(got.cpu().numpy(), sim_fx["count_b"]),
                       ("K3 count vs JAX", order))
            ms, p_ms, r = _alternate(lambda: k3_plain(*args),
                                     lambda: k3(*args))
            n_dev, dev_us, split = _per_call(k3, args)
            _check(n_dev <= 3,
                   ("K3 device kernels per call", order, dtype, n_dev))
            nbytes = sum(a.numel() * a.element_size() for a in args) + 4 * F
            pairs, instr, warp_pairs = _k3_work(args, per_pair[tag])
            brute = _bound_ms(F * L * per_pair[tag][1], rate, nbytes)
            bnd = _bound_ms(instr, rate, nbytes)
            k3_times[(order, tag)] = (ms, p_ms, bnd, n_dev)
            print(f"K3 F={F} L={L} {tag} {order}: equal to plain, "
                  f"{int(got.sum())} in boxes; kernel {ms:.4f} ms "
                  f"({r[1]:.4f}, {r[2]:.4f}), {n_dev} device kernels and "
                  f"{_us(dev_us)} µs of device time a call ("
                  + ", ".join(f"{k.split('::')[-1].split('(')[0]} {v:.2f}"
                              for k, v in split.items())
                  + f"); plain "
                  f"{p_ms:.4f} ms ({r[0]:.4f}, {r[3]:.4f}); pairs left by "
                  f"the exact cull {pairs:.0f} of {F * L} "
                  f"({100 * pairs / (F * L):.3f}%), {warp_pairs:.0f} at a "
                  f"warp's granularity; bound {bnd[0]:.6f} ms ({bnd[1]}) "
                  f"after the cull, {brute[0]:.4f} ms ({brute[1]}) by brute "
                  f"force  [{smi}]")
    small = torch.tensor([[170.0, -10.0, 200.0, 10.0],
                          [float("inf"), float("inf"), -float("inf"),
                           -float("inf")],
                          [float("nan"), -10.0, 10.0, 10.0],
                          [-5.0, -5.0, 5.0, 5.0]], device=dev)
    lon_s = torch.tensor([175.0, -175.0, 0.0, 5.0, -170.0], device=dev)
    lat_s = torch.tensor([0.0, 5.0, 0.0, 0.0, 0.0], device=dev)
    best_s = torch.ones(5, dtype=torch.bool, device=dev)
    for dtype in (torch.float64, torch.float32):
        s_args = (small.to(dtype), lon_s.to(dtype), lat_s.to(dtype), best_s)
        got = k3(*s_args)
        _check(got.tolist() == k3_plain(*s_args).tolist() == [3, 0, 0, 1],
               ("K3 small", got.tolist()))
    print("K3 small case (wrapped, empty, NaN, edge boxes): equal to plain")

    phase_done(8)

    # 9. the main path from the port's own generator
    solve.launches = k3.launches = 0
    t0 = time.time()
    seq = pipeline.simulate_sequence(seed, device=dev, **kw_a)
    wall_sim = time.time() - t0
    res9 = pipeline.run_streaming(seq, seed=seed, cfg=cfg, device=dev)
    wall_9 = time.time() - t0
    k3_launches, k1_main = k3.launches, solve.launches
    _, nw9 = n_windows(*pipeline.stream_inputs(seq), seed)
    t5_9 = ate.time_to_threshold(res9.errors, res9.times, 5.0)
    print(f"own arc (seed {seed}, mode a): {len(seq.det_rows)} rows, {nw9} "
          f"windows, {len(res9.errors)} errors, time_to_5km_s {t5_9}, "
          f"final_error_km {float(res9.errors[-1]):.6f}, max error "
          f"{float(res9.errors.max()):.3f} km; sim {wall_sim:.2f} s, sim + "
          f"stream {wall_9:.2f} s; launches K3 {k3_launches}, K1 {k1_main}"
          f"  [{smi}]")
    _check(np.isfinite(seq.det_rows).all() and np.isfinite(res9.errors).all()
           and np.isfinite(res9.final_states).all(), "own arc finite")
    _check(nw9 >= 2 and float(res9.errors[-1]) < 5.0,
           (nw9, float(res9.errors[-1])))
    _check(k3_launches > 0, "K3 was not launched on the main path")

    phase_done(9)

    # 10. K2 against its plain twin at the long arc's shape
    n_knots = len(la_fx["states0"])
    rng = np.random.default_rng(10)
    w_np = rng.random((n_knots, 4))
    w_np[::5, -1] = 0.0  # empty observation slots
    k2_args = [torch.as_tensor(a, device=dev) for a in (
        rng.normal(size=(n_knots, 4, 2, 9)) * 50.0,
        rng.normal(size=(n_knots, 4, 2)), w_np)]
    k2_err = 0.0
    for f32, tol in ((False, 1e-12), (True, 1e-5)):
        G, g = k2(*k2_args, f32=f32)
        G_p, g_p = k2_plain(*k2_args, f32=f32)
        torch.cuda.synchronize()
        err = max(float((G - G_p).abs().max() / G_p.abs().max()),
                  float((g - g_p).abs().max() / g_p.abs().max()))
        print(f"K2 N={n_knots} D=4 f64{' (f32 sums)' if f32 else ''}: rel "
              f"err vs plain {err:.3e}")
        _check(np.isfinite(err) and err <= tol, ("K2", f32, err))
        if not f32:
            k2_err = max(float((G - G_p).abs().max()),
                         float((g - g_p).abs().max()))
    k2_ms, k2_plain_ms, r = _alternate(lambda: k2_plain(*k2_args),
                                       lambda: k2(*k2_args))
    J2, r2, w2 = k2_args
    JW2 = J2 * w2[..., None, None]
    k2_lib_ms = _time_ms(lambda: (torch.einsum("ndki,ndkj->nij", JW2, J2),
                                  torch.einsum("ndki,ndk->ni", JW2, r2)))
    k2_call = {f32: _per_call(k2, k2_args, f32=f32)
               for f32 in (False, True)}
    for f32, (n_dev, _, _) in k2_call.items():
        _check(n_dev == 1, ("K2 device kernels per call", f32, n_dev))
    rows = 2 * 4
    # per row: 9 products J w, then 45 + 9 FMAs (G's upper triangle, g)
    k2_bound = _bound_ms(n_knots * rows * (9 + 2 * 54), PEAK_F64,
                         8 * (sum(a.numel() for a in k2_args)
                              + n_knots * 90))
    print(f"K2 time N={n_knots} D=4 f64: kernel {k2_ms:.4f} ms a call "
          f"({r[1]:.4f}, {r[2]:.4f}; 20 back to back), "
          f"{_us(k2_call[False][1])} µs of device time a call "
          f"({_us(k2_call[True][1])} with f32=True), device kernels a call "
          f"{k2_call[False][0]} ({k2_call[True][0]} with f32=True); plain "
          f"{k2_plain_ms:.4f} ms ({r[0]:.4f}, {r[3]:.4f}), the two einsums "
          f"{k2_lib_ms:.4f} ms, bound {k2_bound[0]:.6f} ms ({k2_bound[1]})"
          f"  [{smi}]")

    phase_done(10)

    # 11. the long arc from JAX's data
    n_arc = int(la_fx["n_arc"])
    la_kw = json.loads(str(la_fx["problem_kwargs"]))
    solve_kw = json.loads(str(la_fx["solve_kwargs"]))
    t0 = time.time()
    prob, gt_la, kt_la, n_real = long_arc.build_sharded_problem(
        la_fx, n_arc=n_arc, device=dev, **la_kw)
    t_build = time.time() - t0
    st0 = prob.states.reshape(-1, 10).cpu().numpy()
    d0 = float(np.abs(st0 - la_fx["states0"]).max()
               / np.abs(la_fx["states0"]).max())
    print(f"long arc: {n_real} knots of {len(st0)} over {n_arc} shards, "
          f"built in {t_build:.2f} s, initial states rel err vs JAX "
          f"{d0:.3e}")
    _check(n_real == int(la_fx["n_real"]) and d0 <= 1e-12, (n_real, d0))
    _check(np.array_equal(kt_la, la_fx["knot_times"]), "knot times")
    la_mesh = mesh.make_mesh(1, n_arc, device=dev)
    res1 = long_arc.solve_long_arc(la_mesh, prob, gt_la, kt_la, n_real,
                                   num_iters=1,
                                   init_iters=solve_kw["init_iters"])
    d1 = float(np.abs(res1.states - la_fx["states_iter1"]).max()
               / np.abs(la_fx["states_iter1"]).max())
    print(f"long arc: states after iteration 1 rel err vs JAX {d1:.3e}")
    _check(d1 <= 1e-9, d1)
    solve.launches = k2.launches = k3.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    res11 = long_arc.solve_long_arc(la_mesh, prob, gt_la, kt_la, n_real,
                                    **solve_kw)
    wall_11 = time.time() - t0
    k2_launches = k2.launches
    _check(k2_launches == solve_kw["num_iters"],
           ("K2 launches on the long arc", k2_launches))
    _check(solve.launches == k3.launches == 0,
           (solve.launches, k3.launches))
    t0 = time.time()
    long_arc.solve_long_arc(la_mesh, prob, gt_la, kt_la, n_real, **solve_kw)
    wall_11b = time.time() - t0
    e_jax = la_fx["errors_km"]
    d_err = float(np.abs(res11.errors_km - e_jax).max())
    med, med_jax = float(np.median(res11.errors_km)), float(np.median(e_jax))
    print(f"long arc: {solve_kw['num_iters']} iterations "
          f"({solve_kw['init_iters']} vision-only), median error {med:.6f} "
          f"km (JAX {med_jax:.6f}), max {res11.errors_km.max():.6f} km "
          f"(JAX {e_jax.max():.6f}), max |d error| vs JAX {d_err:.3e} km; "
          f"K2 launches {k2_launches}; wall {wall_11:.2f} s, timed "
          f"{wall_11b:.2f} s  [{smi}]")
    _check(np.isfinite(res11.states).all(), "long arc finite")
    _check(d_err <= 0.01 and abs(med - med_jax) <= 1e-3, (d_err, med))
    # where the long arc's time goes: two iterations (one vision-only, one
    # full) under the profiler; a whole solve's trace takes minutes to read
    wall_p, per = _device_profile(lambda: long_arc.solve_long_arc(
        la_mesh, prob, gt_la, kt_la, n_real, num_iters=2, init_iters=1))
    if per:
        n_dev = sum(c for c, _ in per.values()) / 2
        busy = sum(t for _, t in per.values()) * 1e-6 / 2
        k2_dev = [(c, t) for k, (c, t) in per.items() if "normal_eq" in k]
        k2_us = (f"{k2_dev[0][1] / k2_dev[0][0]:.2f} µs per launch"
                 if k2_dev else "not found")
        top = sorted(per.items(), key=lambda kv: -kv[1][1])[:5]
        it_wall = wall_11b / solve_kw["num_iters"]
        print(f"long arc profiled (2 iterations): {n_dev:.0f} device kernels "
              f"and copies per iteration, device busy {1e3 * busy:.2f} ms per "
              f"iteration: {100 * busy / it_wall:.1f}% of the unprofiled "
              f"{1e3 * it_wall:.1f} ms per iteration "
              f"({100 * busy / (wall_p / 2):.1f}% of the profiled); K2 device "
              f"time {k2_us}  [{smi}]")
        for name_k, (cnt, t_us) in top:
            print(f"  {t_us * 1e-3:9.2f} ms  {cnt:7d}x  {name_k[:90]}")
    else:
        print("long arc profiled: the profiler saw no device activity; "
              "device busy share not measured")

    phase_done(11)

    # 12. the port's own long arc
    solve.launches = k2.launches = k3.launches = 0
    t0 = time.time()
    seq12 = pipeline.simulate_sequence(
        int(la_fx["seed"]), device=dev,
        **json.loads(str(la_fx["sim_kwargs"])))
    wall_sim12 = time.time() - t0
    prob12, gt12, kt12, n12 = long_arc.build_sharded_problem(
        seq12, n_arc=n_arc, device=dev, **la_kw)
    res12 = long_arc.solve_long_arc(la_mesh, prob12, gt12, kt12, n12,
                                    **solve_kw)
    wall_12 = time.time() - t0
    k3_12, k2_12 = k3.launches, k2.launches
    med12 = float(np.median(res12.errors_km))
    print(f"own long arc (seed {int(la_fx['seed'])}): {len(seq12.det_rows)} rows, {n12} "
          f"knots, median error {med12:.6f} km, max "
          f"{res12.errors_km.max():.6f} km; sim {wall_sim12:.2f} s, sim + "
          f"solve {wall_12:.2f} s; launches K3 {k3_12}, K2 {k2_12}  [{smi}]")
    _check(np.isfinite(seq12.det_rows).all()
           and np.isfinite(res12.states).all(), "own long arc finite")
    _check(med12 < 5.0, med12)
    _check(k3_12 > 0 and k2_12 > 0, (k3_12, k2_12))

    phase_done(12)

    # 13. config 4, the constellation, from JAX's data
    c4 = np.load(CONST_FIXTURE)
    kw4 = json.loads(str(c4["sim_kwargs"]))
    seeds4 = [int(v) for v in c4["seeds"]]
    iters4, init4 = int(c4["num_iters"]), int(c4["init_iters"])
    k3.launches = 0
    t0 = time.time()
    seqs4 = [pipeline.simulate_from_draws(_fixture_draws(c4, str(s4)),
                                          device=dev, **kw4)
             for s4 in seeds4]
    wall_sim4 = time.time() - t0
    k3_4 = k3.launches
    print(f"config 4: {len(seeds4)} orbits simulated from JAX's draws in "
          f"{wall_sim4:.2f} s ({kw4['duration_s']} s arcs, frame_stride "
          f"{kw4['frame_stride']}), K3 launches {k3_4}  [{smi}]")
    for s4, sq in zip(seeds4, seqs4):
        _rows_check(f"config 4 seed {s4}", sq.det_rows, c4[f"det_rows_{s4}"],
                    1e-9)
    _check(k3_4 == len(seeds4), ("K3 launches in config 4's sims", k3_4))
    batch = pipeline._prepare_constellation(
        seeds4, seqs4, kw4["duration_s"], cfg, None, None, dev)
    B4, n_pad4 = batch.states0.shape[0], batch.states0.shape[1]
    m_pad4 = batch.prob.ii.shape[1]
    print(f"config 4: orbits {batch.seeds} (JAX {c4['valid_seeds'].tolist()}"
          f"), n_pad {n_pad4} (JAX {int(c4['n_pad'])}), m_pad {m_pad4} (JAX "
          f"{int(c4['m_pad'])}), num_hops {batch.params.num_hops}")
    _check(batch.seeds == c4["valid_seeds"].tolist()
           and n_pad4 == int(c4["n_pad"]) and m_pad4 == int(c4["m_pad"]),
           "config 4 batch")

    def solve4(num_iters):
        return window.solve_window_batch(
            batch.states0, batch.prob, batch.lamda, init4, num_iters,
            batch.params, sched_offset=-init4)[0]

    it1 = solve4(1)
    d1_4 = float((it1.cpu() - torch.as_tensor(c4["states_iter1"])).abs().max()
                 / np.abs(c4["states_iter1"]).max())
    print(f"config 4: states after iteration 1 rel err vs JAX {d1_4:.3e}")
    _check(d1_4 <= 1e-9, ("config 4 iteration 1", d1_4))
    # the main path, the sequences through the port's constellation entry:
    # every K1 launch and its (B, N), and the first and last systems'
    # inputs, recorded
    solve.launches = k3.launches = 0
    k1_shapes4 = collections.Counter()
    k1_first, k1_last = [], []

    def on_launch4(D, U, b):
        k1_shapes4[tuple(D.shape[:2])] += 1
        k1_last[:] = [a.clone() for a in (D, U, b)]
        if not k1_first:
            k1_first[:] = k1_last

    torch.cuda.reset_peak_memory_stats()
    with _k1_recording(on_launch4):
        res4 = pipeline.constellation_from_sequences(
            seeds4, seqs4, kw4["duration_s"], iters4, init4, cfg, device=dev)
    k1_launches4 = solve.launches
    peak4 = torch.cuda.max_memory_allocated() / 2**20
    med4, wall4 = res4["median_errors_km"], res4["wall_s"]
    _check(res4["orbit_seeds"] == batch.seeds and res4["num_orbits"] == B4,
           ("config 4 orbits", res4["orbit_seeds"]))
    # the same solve again, timed alone, for the states
    torch.cuda.synchronize()
    t0 = time.time()
    out4 = solve4(iters4)
    torch.cuda.synchronize()
    wall4_again = time.time() - t0
    d_med = np.abs(np.array(med4) - c4["median_errors_km"])
    d_med_t = np.abs(np.array(med4) - c4["median_errors_km_thomas"])
    d_out = float((out4.cpu() - torch.as_tensor(c4["out_b"])).abs().max())
    print(f"config 4: {iters4} iterations ({init4} vision-only) of {B4} "
          f"orbits x N={n_pad4} in one batch: median errors "
          + ", ".join(f"{e:.6f}" for e in med4)
          + f" km; max |d| vs JAX {d_med.max():.3e} km (vs JAX's Thomas-solve "
          f"run {d_med_t.max():.3e} km), max |d state| vs JAX {d_out:.3e}")
    _check(np.isfinite(out4.cpu().numpy()).all(), "config 4 finite")
    _check(float(d_med.max()) <= 1e-3, ("config 4 medians", d_med.tolist()))
    med4_again = [float(np.median(np.linalg.norm(
        out4[i, :len(gt), :3].cpu().numpy() - gt[:, :3], axis=-1)))
        for i, gt in enumerate(batch.gt_states)]
    _check(np.allclose(med4_again, med4, rtol=0, atol=1e-9),
           ("config 4 repeat", med4_again, med4))
    print(f"config 4: K1 launches {k1_launches4}, by (B, N): "
          + ", ".join(f"{bn[0]}x{bn[1]}: {c}"
                      for bn, c in sorted(k1_shapes4.items())))
    _check(k1_launches4 > 0 and set(k1_shapes4) == {(B4, n_pad4)}
           and sum(k1_shapes4.values()) == k1_launches4,
           ("config 4 K1 launches", dict(k1_shapes4)))
    _check(k3.launches == 0, ("K3 in the solve", k3.launches))
    print(f"config 4 batched solve wall: {wall4:.2f} s (the entry's solve; "
          f"{wall4_again:.2f} s again) -> "
          f"{res4['orbit_frames_per_s']:.1f} orbit-frames/s; peak device "
          f"memory {peak4:.1f} MiB  [{smi}]")

    def orbit(prob_b, i):
        return ba.BAProblem(*[
            getattr(prob_b, f) if f == "intrinsics" else getattr(prob_b, f)[i]
            for f in ba.BAProblem._fields])

    # the same padded problems one orbit at a time
    torch.cuda.synchronize()
    t0 = time.time()
    seq_out = [window._solve_window(
        batch.states0[i], orbit(batch.prob, i), float(batch.lamda[i]), init4,
        iters4, batch.params, -init4)[0]
        for i in range(B4)]
    torch.cuda.synchronize()
    wall4_seq = time.time() - t0
    d_seq = float((torch.stack(seq_out) - out4).abs().max()
                  / out4.abs().max())
    print(f"config 4 sequential: {B4} single-orbit solves {wall4_seq:.2f} s "
          f"({wall4_seq / wall4:.2f}x the batch) -> "
          f"{B4 * kw4['duration_s'] / wall4_seq:.1f} orbit-frames/s; states "
          f"rel err vs the batch {d_seq:.3e}  [{smi}]")
    _check(d_seq <= 1e-9, ("batched vs sequential", d_seq))
    # device kernels of one LM iteration (dynamics on): the batch, one orbit
    one = orbit(batch.prob, 0)
    for tag, fn in (
            ("batched", lambda: ba.ba_iteration(
                0, out4, batch.prob, batch.lamda, params=batch.params)),
            ("one orbit", lambda: ba.ba_iteration(
                0, out4[0], one, float(batch.lamda[0]),
                params=batch.params))):
        fn()
        wall_p, per = _device_profile(fn)
        if per:
            n_dev = sum(c for c, _ in per.values())
            busy = sum(t for _, t in per.values()) * 1e-3
            k1_dev = [(c, t) for k, (c, t) in per.items() if "pcr" in k]
            print(f"config 4 iteration profiled ({tag}): {n_dev} device "
                  f"kernels and copies, device busy {busy:.2f} ms of "
                  f"{1e3 * wall_p:.1f} ms ({100 * busy / (1e3 * wall_p):.1f}"
                  f"%), K1 {k1_dev[0][0] if k1_dev else 0} launches, "
                  f"{(k1_dev[0][1] / k1_dev[0][0]) if k1_dev else 0:.2f} µs "
                  f"each  [{smi}]")
        else:
            print(f"config 4 iteration profiled ({tag}): the profiler saw "
                  f"no device activity; not measured")
    # K1 at config 4's shape: on Jacobi-scaled random blocks as phase 3
    # (1e-9), then on the run's own first and last systems.  The first
    # (vision-only: U = 0, so Thomas and the twin run the same per-block
    # elimination) has 9x9 blocks of condition ~5e11, where any two
    # eliminations part by ~1e-8: K1 is held between its own reading
    # (1.6e-8) and the dense LU's distance from the twin (3.8e-8), and to a
    # stable solve's backward error.  The last (dynamics on) is held near
    # its reading (1.1e-11; Thomas 2.5e-11 from the twin).
    Dr, Ur, br = (torch.as_tensor(a, device=dev)
                  for a in _problem(np.random.default_rng(13), B4, n_pad4))
    xr, xpr = solve(Dr, Ur, br), plain(Dr, Ur, br)
    k1_err4 = float((xr - xpr).abs().max() / xpr.abs().max())
    print(f"K1 N={n_pad4} B={B4} f64 (config 4, batched U): rel err vs plain "
          f"{k1_err4:.3e} on random scaled blocks")
    k1_run4 = {}
    for tag, (D4, U4, b4) in (("first", k1_first), ("last", k1_last)):
        x4, xp4 = solve(D4, U4, b4), plain(D4, U4, b4)
        xt4 = ba.block_tridiag_solve(D4, U4, b4)
        A4 = _dense(D4, U4)
        xd4 = torch.linalg.solve(A4, b4.reshape(B4, -1, 1)).reshape(b4.shape)
        del A4
        d = {name: float((x - xp4).abs().max() / xp4.abs().max())
             for name, x in (("K1", x4), ("Thomas", xt4), ("dense LU", xd4))}
        bw = {name: _backward(D4, U4, b4, x)
              for name, x in (("K1", x4), ("plain", xp4), ("Thomas", xt4),
                              ("dense LU", xd4))}
        k1_run4[tag] = (d["K1"], bw["K1"])
        print(f"K1 N={n_pad4} B={B4} f64 (config 4, the run's {tag} system, "
              f"max |U| {float(U4.abs().max()):.3e}): rel err vs plain "
              + ", ".join(f"{k} {v:.3e}" for k, v in d.items())
              + "; backward error " + ", ".join(f"{k} {v:.2e}"
                                                for k, v in bw.items()))
    _check(k1_err4 <= 1e-9 and k1_run4["first"][0] <= 3e-8
           and k1_run4["first"][1] <= 1e-14 and k1_run4["last"][0] <= 3e-11,
           ("K1 at config 4", k1_err4, k1_run4))
    D4, U4, b4 = k1_last
    k1_shape4 = _k1_at_shape(D4, U4, b4, PEAK_F64,
                             "config 4, batched U, the run's last system",
                             smi)
    # what a per-candidate copy of per-orbit U would cost with K=9 batched
    # λ candidates (the port needs none: the Jacobi-scaled U is already one
    # per candidate)
    u_copy_ms = _time_ms(lambda: U4.expand(9, *U4.shape).reshape(
        9 * B4, *U4.shape[1:]).contiguous())
    print(f"config 4: per-orbit U copied for K=9 candidates "
          f"({9 * U4.numel() * 8 / 1e6:.1f} MB): {u_copy_ms:.4f} ms  [{smi}]")
    phase_done(13)

    # 14. the evaluation: the mode-b orbit from JAX's draws, then the
    # port's own two orbits
    ev = np.load(EVAL_FIXTURE)
    seed_b = int(ev["seed"])
    _, nw14 = n_windows(*pipeline.stream_inputs(seq_b), seed_b)
    solve.launches = 0
    t0 = time.time()
    res14 = pipeline.run_streaming(seq_b, seed=seed_b, cfg=cfg, device=dev)
    wall14 = time.time() - t0
    k1_14 = solve.launches
    t5_14 = ate.time_to_threshold(res14.errors, res14.times, 5.0)
    final14 = float(res14.errors[-1])
    t0 = time.time()
    cb14 = crlb.terminal_crlb_km(seq_b.orbit_pos_eci_km, seq_b.det_rows,
                                 device=dev)
    wall_cb = time.time() - t0
    d_cb = max(abs(cb14[k] - float(ev[k])) / abs(float(ev[k]))
               for k in ("crlb_final_km", "crlb_last_knot_km",
                         "crlb_att_final_km"))
    print(f"eval orbit (mode b, seed {seed_b}): {nw14} windows (JAX "
          f"{int(ev['num_windows'])}), time_to_5km_s {t5_14} (JAX "
          f"{float(ev['time_to_5km_s'])}), final_error_km {final14:.6f} (JAX "
          f"{float(ev['final_error_km']):.6f}), recovery_trips "
          f"{res14.recovery_trips}; stream {wall14:.2f} s, K1 launches "
          f"{k1_14}; crlb_final_km {cb14['crlb_final_km']:.6f}, "
          f"crlb_att_final_km {cb14['crlb_att_final_km']:.6f} (max rel err "
          f"vs JAX {d_cb:.3e}) in {wall_cb:.2f} s  [{smi}]")
    _check(np.isfinite(res14.errors).all(), "eval orbit finite")
    _check(nw14 == int(ev["num_windows"])
           and t5_14 == float(ev["time_to_5km_s"])
           and abs(final14 - float(ev["final_error_km"])) <= 0.01,
           ("eval orbit", nw14, t5_14, final14))
    _check(d_cb <= 1e-6 and cb14["n_obs"] == int(ev["n_obs"]),
           ("eval orbit CRLB", d_cb))
    # run_batch_eval's streams recorded as it makes them, for the rows
    solve.launches = k3.launches = 0
    streamed = []

    def record_stream(run, seq, seed=0, **kw):
        res = run(seq, seed=seed, **kw)
        streamed.append((seq, res, seed))
        return res

    t0 = time.time()
    with _patched(pipeline, "run_streaming", record_stream):
        summary14 = pipeline.run_batch_eval([0, 1], EVAL_DURATION_S,
                                            cfg=cfg, device=dev)
    wall_ev = time.time() - t0
    k1_ev, k3_ev = solve.launches, k3.launches
    rows14 = [pipeline.eval_row(sq, r, s, device=dev)
              for sq, r, s in streamed]
    print(f"run_batch_eval([0, 1], {EVAL_DURATION_S}): {wall_ev:.2f} s, K1 "
          f"launches {k1_ev}, K3 launches {k3_ev}; summary "
          + json.dumps(summary14) + f"  [{smi}]")
    for row in rows14:
        print("  eval row " + json.dumps(row))
    _check(np.isfinite(summary14["median_final_error_km"]),
           ("eval summary", summary14))
    _check(k3_ev == 2 and k1_ev > 0, ("eval launches", k3_ev, k1_ev))
    phase_done(14)

    # 15. the f32 stream: the fixture's rows in f32 on the card, its f64
    # escapes on the card too
    prec = torch.get_float32_matmul_precision()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    print(f"f32 matmul precision {prec!r}, cuda.matmul.allow_tf32 {tf32}")
    _check(prec == "highest" and not tf32, ("TF32 would round f32", prec,
                                            tf32))
    md = np.load(MODES_FIXTURE)
    cfg32 = window.StreamingConfig(dtype="float32")
    k1_by = collections.Counter()  # (dtype, B, N) -> launches
    k1_sys32 = []  # the first and the last f32 system of the run
    escape_s = {"init": 0.0, "all": 0.0}
    keep = [False]  # keep the f32 systems of this run

    def on_launch15(D, U, b):
        k1_by[(str(D.dtype)[6:], D.shape[0], D.shape[1])] += 1
        if keep[0] and D.dtype == torch.float32:
            sys_ = [a.clone() for a in (D, U, b)]
            k1_sys32[:] = [k1_sys32[0] if k1_sys32 else sys_, sys_]

    def timed(key):
        def hook(fn, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                escape_s[key] += time.time() - t0
        return hook

    def stream32(seq_in, s, cfg_in, record=False):
        """One f32 stream with K1's launches by dtype and shape and the
        seconds in the f64 escapes recorded: (result, wall s)."""
        k1_by.clear()
        escape_s.update(init=0.0, all=0.0)
        solve.launches = 0
        keep[0] = record
        t0 = time.time()
        with _k1_recording(on_launch15), \
                _patched(window, "_window0_init_f64", timed("init")), \
                _patched(window, "_solve_window_f64", timed("all")):
            r = pipeline.run_streaming(seq_in, seed=s, cfg=cfg_in,
                                       device=dev)
        return r, time.time() - t0

    res32, cold32 = stream32(fx, seed, cfg32, record=True)
    k1_launches32 = solve.launches
    by32 = dict(k1_by)
    esc32 = dict(escape_s)
    walls32 = [stream32(fx, seed, cfg32)[1]]
    t5_32 = ate.time_to_threshold(res32.errors, res32.times, 5.0)
    final32 = float(res32.errors[-1])
    jax32 = float(md["f32_final_error_km"])
    print(f"f32 stream: {nw} windows, time_to_5km_s {t5_32} (JAX f64 "
          f"{ref_t5}, JAX f32 {float(md['f32_time_to_5km_s'])}), "
          f"final_error_km {final32:.6f} (JAX f64 {ref_final:.6f}, JAX f32 "
          f"{jax32:.6f}, port f64 {final:.6f}), recovery_trips "
          f"{res32.recovery_trips} (JAX f32 {int(md['f32_recovery_trips'])})")
    print(f"f32 stream wall: cold {cold32:.2f} s, timed "
          + " / ".join(f"{w:.2f} s" for w in walls32)
          + " (f64, phase 4: " + " / ".join(f"{w:.2f} s" for w in walls)
          + f"); f64 escapes {esc32['all']:.2f} s, of which window 0's "
          f"init {esc32['init']:.2f} s  [{smi}]")
    print(f"f32 stream: K1 launches {k1_launches32}, by (dtype, B, N): "
          + ", ".join(f"{k[0]} {k[1]}x{k[2]}: {c}"
                      for k, c in sorted(by32.items())))
    _check(np.isfinite(res32.errors).all()
           and np.isfinite(res32.final_states).all(), "f32 stream finite")
    _check(len(res32.times) == len(fx["times"])
           and np.array_equal(res32.times, fx["times"]), "f32 windows")
    _check(t5_32 == ref_t5 == 275.0, ("f32 time to 5 km", t5_32))
    _check(abs(final32 - ref_final) <= 0.01 and abs(final32 - jax32) <= 0.01
           and abs(final32 - final) <= 0.01,
           ("f32 final error", final32, ref_final, jax32, final))
    n32 = sum(c for k, c in by32.items() if k[0] == "float32")
    _check(n32 > 0 and sum(by32.values()) == k1_launches32,
           ("K1 in f32 on the stream", by32))
    # K1 on the stream's own first and last f32 systems: against its twin
    # on the card, and against Thomas of the same system cast up to f64
    k1_run32, k1_dist32 = {}, {}
    for tag, (D32, U32, b32) in zip(("first", "last"), k1_sys32):
        x32, xp32 = solve(D32, U32, b32), plain(D32, U32, b32)
        D64, U64, b64 = (a.double() for a in (D32, U32, b32))
        xt64 = ba.block_tridiag_solve(D64, U64, b64)
        d = {name: float((x.double() - xt64).abs().max()
                         / xt64.abs().max())
             for name, x in (("K1", x32), ("plain", xp32))}
        d_tw = float((x32 - xp32).abs().max() / xp32.abs().max())
        bw = {name: _backward(D64, U64, b64, x.double())
              for name, x in (("K1", x32), ("plain", xp32),
                              ("Thomas f64", xt64))}
        k1_run32[tag] = (d_tw, d["K1"], bw["K1"], bw["plain"], tuple(
            D32.shape[:2]))
        k1_dist32[tag] = d["plain"]
        print(f"K1 B={D32.shape[0]} N={D32.shape[1]} f32 (the f32 stream's "
              f"{tag} system): rel err vs plain {d_tw:.3e}; vs f64 Thomas "
              + ", ".join(f"{k} {v:.3e}" for k, v in d.items())
              + "; backward error (f64 residual) "
              + ", ".join(f"{k} {v:.2e}" for k, v in bw.items()))
    # limits between the readings (PERF.md §2, §6).  The first system
    # (window 0 from its f64 warm start) reads the same in every call:
    # 1.0e-5 from the twin, backward error 5.4e-5 (twin 5.1e-5).  The last
    # (N=448, dynamics on) changes from call to call with the stream's f32
    # roundoff, and any f32 PCR solve of it is only good to ~2e-3 to 5e-3
    # (backward errors 6e-4 to 3.1e-3, ~1e4 unit roundoffs, as PCR's ~1e5
    # in f64 at config 4), the twin's as much as K1's: K1 is held to the
    # twin's own readings on the same system, its distance from f64 Thomas
    # within 2x the twin's (0.94-1.24x measured), its backward error within
    # 4x (0.7-3.1x), its distance from the twin within 3x the twin's from
    # Thomas (0.64-1.8x)
    d_tw, d_k1, bw_k1, bw_pl, _ = k1_run32["first"]
    lim = {"first": d_tw <= 1e-4 and bw_k1 <= 1e-4}
    d_tw, d_k1, bw_k1, bw_pl, _ = k1_run32["last"]
    tw = k1_dist32["last"]
    lim["last"] = (d_k1 <= 2 * tw and bw_k1 <= 4 * bw_pl and d_tw <= 3 * tw
                   and np.isfinite(d_tw))
    _check(all(lim.values()), ("K1 on the f32 stream's systems", k1_run32,
                               k1_dist32))
    k1_shape32 = _k1_at_shape(*k1_sys32[1], PEAK_F32,
                              "the f32 stream's last system", smi)
    # what window 0's f64 init buys on the card: printed, not gated
    res_noinit, wall_noinit = stream32(
        fx, seed, cfg32._replace(window0_init_f64=False))
    t5_n = ate.time_to_threshold(res_noinit.errors, res_noinit.times, 5.0)
    print(f"f32 stream without window 0's f64 init: time_to_5km_s {t5_n}, "
          f"final_error_km {float(res_noinit.errors[-1]):.6f}, min "
          f"{float(res_noinit.errors.min()):.6f}, recovery_trips "
          f"{res_noinit.recovery_trips}, f64 escapes "
          f"{escape_s['all']:.2f} s, wall {wall_noinit:.2f} s  [{smi}]")
    # a forced escalation on config 3's gapped sequence: no window can
    # pass a 1e-3 px gate, so every one is solved again in f64 (at the
    # fixed 20-iteration budget: each window is solved three times)
    seq3 = {"det_rows": md["det_rows_3"],
            "orbit_pos_eci_km": md["orbit_pos_eci_km_3"]}
    res_esc, wall_esc = stream32(
        seq3, seed, cfg32._replace(recover_rms_px=1e-3, max_iters=0))
    _, nw_esc = n_windows(*pipeline.stream_inputs(seq3), seed)
    print(f"f32 forced escalation (config 3's sequence, recover_rms_px "
          f"1e-3, max_iters 0): {nw_esc} windows, recovery_trips "
          f"{res_esc.recovery_trips}, min error "
          f"{float(res_esc.errors.min()):.6f} km, final "
          f"{float(res_esc.errors[-1]):.6f} km; f64 escapes "
          f"{escape_s['all']:.2f} s of {wall_esc:.2f} s; K1 by (dtype, B, "
          f"N): " + ", ".join(f"{k[0]} {k[1]}x{k[2]}: {c}"
                              for k, c in sorted(k1_by.items()))
          + f"  [{smi}]")
    _check(res_esc.recovery_trips == nw_esc >= 2
           and np.isfinite(res_esc.errors).all()
           and float(res_esc.errors.min()) < 2.0,
           ("forced escalation", res_esc.recovery_trips, nw_esc))
    _check(any(k[0] == "float64" for k in k1_by), "K1 in f64 escapes")

    phase_done(15)

    # 16. BASELINE configs 1-3, first on JAX's rows, then config 3 from
    # the port's own generator
    def fx_seq(tag):
        d = {"det_rows": md[f"det_rows_{tag}"],
             "orbit_pos_eci_km": md[f"orbit_pos_eci_km_{tag}"]}
        if tag == "3":
            d.update(db_lon=md["db_lon_3"], db_lat=md["db_lat_3"])
        return d

    k1_last16 = []

    def on_launch16(D, U, b):
        k1_by[(str(D.dtype)[6:], D.shape[0], D.shape[1])] += 1
        k1_last16[:] = [a.clone() for a in (D, U, b)]

    def run_config(tag, fn, *a, **kw):
        """A runner on the card: (its dict, K1 by (dtype, B, N), the
        results of the streams it ran, the per-knot errors of the EKF
        passes it ran)."""
        k1_by.clear()
        solve.launches = k3.launches = 0
        streams, ekf_errs = [], []

        def record_stream(run, *sa, **skw):
            streams.append(run(*sa, **skw))
            return streams[-1]

        def record_ekf(run, *ea):
            out = run(*ea)
            ekf_errs.append(out[0])
            return out

        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with _k1_recording(on_launch16), \
                _patched(pipeline, "run_streaming", record_stream), \
                _patched(run_configs, "ekf_errors", record_ekf):
            out = fn(*a, device=dev, **kw)
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 2**20
        print(f"{tag}: wall {wall:.2f} s, peak device memory {peak:.1f} "
              f"MiB, K1 launches {solve.launches}"
              + (" by (dtype, B, N): " + ", ".join(
                  f"{k[0]} {k[1]}x{k[2]}: {c}"
                  for k, c in sorted(k1_by.items())) if k1_by else "")
              + f", K3 launches {k3.launches}; " + json.dumps(out)
              + f"  [{smi}]")
        return out, dict(k1_by), streams, ekf_errs

    def ekf_vs_jax(what, got, want):
        """An EKF pass's per-knot errors against JAX's: within 1e-6 km
        (read ~1e-8 on the CPU), the final and median with them."""
        d = float(np.abs(got - want).max())
        print(f"{what}: final {got[-1]:.9f} km, median "
              f"{np.median(got):.9f} km; per-knot max |d| vs JAX {d:.3e} km "
              f"over {len(got)} knots")
        _check(len(got) == len(want) and d <= 1e-6, (what, d))

    c1, _, _, e1 = run_config("config 1 (JAX's rows)", run_configs.run_ekf,
                              3600, fx_seq("12"))
    ekf_vs_jax("config 1", e1[0], md["c1_errors"])
    _check(c1["final_error_km"] == e1[0][-1], ("config 1 dict", c1))
    print(f"config 1: {c1['knots']} knots, "
          f"{1e3 * c1['wall_s'] / c1['knots']:.3f} ms a knot")
    # device kernels of one EKF knot (predict + update): a CUDA graph's
    # nodes (the step never waits on the host)
    from vinsat_tpu_torch.estimation import ekf as ekf_mod
    st1 = ekf_mod.EKFState(
        torch.as_tensor(md["orbit_pos_eci_km_12"][0].tolist()
                        + [0.0, 0.0, 0.0, 1.0, 0.0, 7.5, 0.0], device=dev,
                        dtype=torch.float64),
        torch.eye(9, device=dev, dtype=torch.float64))
    lm1 = torch.zeros(8, 3, device=dev, dtype=torch.float64)
    lm1[:, 0] = 6378.0
    uv1 = torch.full((8, 2), 1000.0, device=dev, dtype=torch.float64)
    ov1 = torch.ones(8, device=dev, dtype=torch.float64)
    gap1 = torch.tensor(5.0, device=dev, dtype=torch.float64)
    crot1 = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev,
                         dtype=torch.float64)
    intr1 = torch.tensor(run_configs.EKF_INTRINSICS, device=dev,
                         dtype=torch.float64)
    ekf_cfg = ekf_mod.EKFConfig(num_hops=2)

    def knot():
        return ekf_mod.update(ekf_mod.predict(st1, gap1, crot1, ekf_cfg, 1),
                              lm1, uv1, ov1, intr1, ekf_cfg)

    try:
        knot_nodes = f"{_graph_nodes(knot)} (CUDA graph nodes)"
    except RuntimeError as e:  # a step that cannot be captured
        _, per = _device_profile(knot)
        knot_nodes = (f"{sum(c for c, _ in per.values())} (torch.profiler; "
                      f"not capturable: {str(e)[:80]})")
    print(f"config 1: one EKF knot (predict over a 5 s gap, one hop, and "
          f"update with 8 observations) is {knot_nodes} device kernels  "
          f"[{smi}]")

    c2, k1_by2, _, _ = run_config("config 2 (JAX's rows)",
                                  run_configs.run_fullbatch, 3600,
                                  fx_seq("12"))
    m2, m2_auto = (float(np.median(md["c2_errors_thomas"])),
                   float(np.median(md["c2_errors"])))
    d2 = abs(c2["median_error_km"] - m2)
    print(f"config 2: median {c2['median_error_km']:.9f} km; JAX "
          f"(Thomas solve) {m2:.9f}, |d| {d2:.3e} km; JAX (its f64 \"auto\", "
          f"bcr16) {m2_auto:.9f}, |d| "
          f"{abs(c2['median_error_km'] - m2_auto):.3e} km; {c2['knots']} "
          f"knots")
    _check(d2 <= 1e-3 and c2["knots"] == int(md["c2_knots"]),
           ("config 2 vs JAX", d2))
    _check(k1_by2 and all(k[0] == "float64" for k in k1_by2),
           ("K1 in config 2", k1_by2))
    D2, U2, b2 = k1_last16
    x2, xp2 = solve(D2, U2, b2), plain(D2, U2, b2)
    k1_err2 = float((x2 - xp2).abs().max() / xp2.abs().max())
    print(f"K1 N={D2.shape[1]} B={D2.shape[0]} f64 (config 2's last "
          f"system): rel err vs plain {k1_err2:.3e}")
    k1_shape2 = _k1_at_shape(D2, U2, b2, PEAK_F64, "config 2's last system",
                             smi)

    s3 = fx_seq("3")
    idx3, d2_3 = matching.nearest_landmark(
        *(torch.as_tensor(a, device=dev) for a in (
            s3["det_rows"][:, 1:3], s3["db_lon"], s3["db_lat"])))
    idx3 = idx3.cpu().numpy()
    print(f"config 3: matcher indices equal to JAX's: "
          f"{np.array_equal(idx3, md['c3_matcher_idx'])} "
          f"({len(idx3)} detections, {len(s3['db_lon'])} landmarks), max |d "
          f"d2| {np.abs(d2_3.cpu().numpy() - md['c3_matcher_d2']).max():.3e}")
    _check(np.array_equal(idx3, md["c3_matcher_idx"]), "config 3 matcher")
    c3, k1_by3, streams3, e3 = run_config(
        "config 3 (JAX's rows)", run_configs.run_streaming, 3600, s3,
        fx_seq("gap"))
    # the two streams the runner ran, knot by knot: the same recorded
    # times (so the same windows) and errors within 1e-4 km of JAX's (read
    # 4.3e-6 and 1.3e-6 km on the CPU: BA-only windows grow past 64 rows,
    # where JAX's f64 "auto" is bcr16 and the port's is PCR)
    _check(len(streams3) == 2, ("config 3 streams", len(streams3)))
    for tag, r3 in zip(("ba_only", "hybrid"), streams3):
        ref3 = md[f"c3_{tag}_errors"]
        same_t = np.array_equal(r3.times, md[f"c3_{tag}_times"])
        d3 = float(np.abs(r3.errors - ref3).max()) if same_t else np.inf
        print(f"config 3 {tag}: recorded times equal to JAX's: {same_t} "
              f"({len(r3.times)} knots, {int(md[f'c3_{tag}_windows'])} "
              f"windows in JAX), per-knot max |d| vs JAX {d3:.3e} km, "
              f"time_to_5km_s {c3[tag]['time_to_5km_s']} (JAX "
              f"{float(md[f'c3_{tag}_time_to_5km_s'])}), final "
              f"{c3[tag]['final_error_km']:.6f} km (JAX {ref3[-1]:.6f})")
        _check(same_t and d3 <= 1e-4
               and c3[tag]["final_error_km"] == r3.errors[-1]
               and c3[tag]["time_to_5km_s"]
               == float(md[f"c3_{tag}_time_to_5km_s"]),
               ("config 3", tag, d3, c3[tag]))
    _check(len(e3) == 2, ("config 3 EKF passes", len(e3)))
    for tag, e in zip(("ekf_only", "ekf_only_long_gap"), e3):
        ekf_vs_jax(f"config 3 {tag}", e, md[f"c3_{tag}_errors"])
    c3own, _, _, _ = run_config("config 3 (the port's own generator)",
                                run_configs.run_streaming, 3600)
    k3_16 = k3.launches
    _check(all(np.isfinite(c3own[k]["final_error_km"])
               for k in ("ba_only", "hybrid", "ekf_only",
                         "ekf_only_long_gap"))
           and c3own["ba_only"]["final_error_km"] < 5.0
           and c3own["hybrid"]["final_error_km"] < 5.0,
           ("config 3, own generator", c3own))
    _check(k3_16 == 2, ("K3 in config 3's simulations", k3_16))

    phase_done(16)

    # 17-19: the stream modes, config 5(b), and configs 2, 4, 5(a) in f32
    k1_17 = _phase17(dev, smi)
    phase_done(17)
    p18 = _phase18(dev, smi)
    phase_done(18)
    p19 = _phase19(dev, smi, seqs4)
    phase_done(19)

    # 20-21: the arc shards on torch.distributed ranks; the hi-fi truth
    p20 = _phase20(dev, smi)
    phase_done(20)
    p21 = _phase21(dev, smi, step_us["orbit"])
    phase_done(21)

    # 22: the imagery path
    p22 = _phase22(dev, smi)
    phase_done(22)

    print(f"chip_smoke: {time.time() - T_START:.1f} s in all")
    k3_ms, k3_plain_ms, k3_bound, k3_dev = k3_times[("regions", "float64")]
    print(json.dumps({"kernels": [
        {"name": "tridiag_pcr", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": k1_launches,
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "library_ms": k1_lib_ms,
         "design": "one cooperative launch, a grid barrier per PCR level",
         "device_kernels_per_call": k1_rows[(448, "float64")][3],
         "launches_by_path": {"stream": k1_launches, "own_arc": k1_main,
                              "constellation": k1_launches4,
                              "eval_orbit": k1_14, "batch_eval": k1_ev,
                              "f32_stream": k1_launches32,
                              "fullbatch": sum(k1_by2.values()),
                              "config3": sum(k1_by3.values()),
                              "stream_modes": k1_17,
                              "constellation_f32": p19["k1_config4_f32"],
                              "fullbatch_f32": p19["k1_config2_f32"],
                              "hifi_stream": p21["k1"],
                              "imagery_stream": p22["k1"]["imagery_stream"],
                              "imagery_learned_stream":
                                  p22["k1"]["imagery_learned_stream"]},
         "constellation_shape": dict(
             k1_shape4, max_rel_err=k1_err4,
             max_rel_err_run_first=k1_run4["first"][0],
             backward_err_run_first=k1_run4["first"][1],
             max_rel_err_run_last=k1_run4["last"][0]),
         "f32_stream_shape": dict(
             k1_shape32,
             launches_by_dtype={
                 dt: sum(c for k, c in by32.items() if k[0] == dt)
                 for dt in ("float32", "float64")},
             max_rel_err_run={t: r[0] for t, r in k1_run32.items()},
             backward_err_run={t: r[2] for t, r in k1_run32.items()}),
         "fullbatch_shape": dict(
             k1_shape2, launches=sum(k1_by2.values()),
             max_rel_err=k1_err2),
         "constellation_f32_shape": dict(
             p19["k1_shape"], launches=p19["k1_config4_f32"]),
         "fullbatch_f32_shape": dict(
             p19["k1_shape2"], launches=p19["k1_config2_f32"])},
        {"name": "visible_count", "route": "cuda", "source": K3_SOURCE,
         "replaces": K3_REPLACES, "launches": k3_launches,
         "max_abs_err": float(k3_err), "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
         "library_ms": None,
         "design": "tile boxes, then a frame per lane over the tiles the "
                   "boxes leave, staged in shared memory",
         "device_kernels_per_call": k3_dev,
         "launches_by_path": {"own_arc": k3_launches, "constellation": k3_4,
                              "batch_eval": k3_ev, "config3_own": k3_16,
                              "ranks_stream_sim": p20["k3"],
                              "hifi_sim": p21["k3"]}},
        {"name": "normal_eq", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": k2_launches,
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "library_ms": k2_lib_ms,
         "design": "a warp per knot, staged in its shared slot (64 "
                   "observation slots at a time); G's upper triangle "
                   "mirrored",
         "device_kernels_per_call": k2_call[False][0],
         "launches_by_path": {"long_arc": k2_launches,
                              "sharded_stream": p18["launches"],
                              "long_arc_f32": p19["k2_longarc_f32"],
                              "ranks_ba_step": p20["k2"]["ba-step"],
                              "ranks_stream": p20["k2"]["stream"]},
         "sharded_stream_shape": p18["shape"],
         "sharded_stream_f32_shape": p18["shape_f32"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
