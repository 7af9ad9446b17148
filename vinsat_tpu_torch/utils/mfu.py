"""Device time, operations, bytes and roofline share of the LM iteration's
stages on the card (port of vinsat_tpu/utils/mfu.py, re-modelled: torch
has no compiled cost analysis).

Stages of one LM iteration (ba.ba_iteration):
  factors   — the reprojection and dynamics factors with their Jacobians
  assemble  — robust weights and the block normal equations (JᵀWJ, JᵀWr)
  solve     — the Jacobi-scaled block-tridiagonal solve (kernel K1)
  iteration — the whole ba_iteration, λ search and retraction included

Time, two ways:
  device_ms — the looped device time, the JAX module's contract
    (`time_looped`): R data-chained calls of the stage and one call, each
    captured once as a CUDA graph and replayed `repeats` times between
    CUDA events; (t(R) - t(1)) / (R - 1), the medians.  The graphs launch
    the stage's kernels back to back, so the host's launch gaps are not in
    it.  The sequential λ search (batched_lambda = 0) reads the host every
    trial and no graph can hold it: its iteration prints device_ms null
    and says why.
  eager_ms — CUDA events around `repeats` back-to-back eager calls after
    two warm-up calls: what the eager port pays, the host's launch gaps
    included.  eager_ms - device_ms is the host's launch cost.
No L2 flush between calls: each stage finds its inputs in L2, as the real
caller does after the stage before it.

Counts come from the stage's plain PyTorch program, run once on CPU
copies of its inputs under a dispatch mode that sees every aten op:
matrix-product operations by torch.utils.flop_counter's formulas, one
operation an output element for every other op, and bytes as each op
reading its inputs once and writing its outputs once (eager PyTorch runs
an op as its own kernel through device memory).  On the card K1 is one
kernel called through ctypes, which a dispatch mode does not see: its
counts are those of its plain twin, the same PCR arithmetic, whose
intermediate tensors overstate K1's own traffic.

Peaks: NVIDIA's H100 SXM data sheet at 700 W: 67 TFLOP/s in float64 (on
the tensor cores) and in float32 (outside them; their TF32 is not
float32), 3.35 TB/s of HBM3 bandwidth.  Another card has no peaks here:
its shares print as null.

    python -m vinsat_tpu_torch.utils.mfu [--sizes 64,256,1024]
        [--dtype float32] [--repeats 10] [--loop-r 64]
        [--batched-lambda 0] [--stages factors,solve]
        [--tridiag-variant auto]

The first line names the card as nvidia-smi gives it (name, power
limit); then one JSON line a (N, stage).  It needs a card.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode, flop_registry

# (float64 FLOP/s, float32 FLOP/s, bytes/s) a card, by its name
CARD_PEAKS = {"H100": (67e12, 67e12, 3.35e12)}


def card_peaks(name: str) -> Optional[Tuple[float, float, float]]:
    """The data-sheet peaks of a card named `name`, or None."""
    for key, peaks in CARD_PEAKS.items():
        if key in name:
            return peaks
    return None


class _Traffic(TorchDispatchMode):
    """Bytes of every non-view aten op (inputs read once, outputs written
    once) and one operation an output element of the ops that
    flop_counter has no formula for."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.elementwise = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False):
            ins = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
            outs = [a for a in tree_flatten(out)[0]
                    if isinstance(a, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
            if func.overloadpacket not in flop_registry:
                self.elementwise += sum(t.numel() for t in outs)
        return out


def count(fn, *args) -> Dict[str, float]:
    """{'matmul_flops', 'other_ops', 'bytes'} of fn(*args) (CPU tensors)."""
    with FlopCounterMode(display=False) as fc, _Traffic() as tr:
        fn(*args)
    return {"matmul_flops": float(fc.get_total_flops()),
            "other_ops": float(tr.elementwise), "bytes": float(tr.bytes)}


# the most CUDA graph nodes of a looped program: a stage whose R calls
# would exceed it is looped fewer times (eager Thomas at N=4096 launches
# ~180k kernels a call)
NODE_BUDGET = 100_000


class Looped(NamedTuple):
    """A looped timing: seconds an op, the chained ops R of the timed
    program, and the device operations of one op (its CUDA graph's nodes;
    None on the CPU)."""

    seconds: float
    R: int
    nodes: Optional[int]


def make_looped(step_fn, chain_fn, R: int):
    """run(carry, *rest): step_fn R times, each output folded back into the
    carry by chain_fn, so each call depends on the one before (none can be
    skipped or hoisted); returns the last carry."""
    def run(carry, *rest):
        for _ in range(R):
            carry = chain_fn(carry, step_fn(carry, *rest))
        return carry

    return run


def time_looped(step_fn, chain_fn, carry, *rest, R: int = 64,
                repeats: int = 5) -> float:
    """Per-op seconds: (t(R ops) - t(1 op)) / (R - 1) over a
    data-dependent carry (`make_looped`).  On a card each program is
    captured once as a CUDA graph and replayed `repeats` times between
    CUDA events (device time); on the CPU it is a plain loop timed by
    perf_counter.  The medians of the repeats."""
    return looped(step_fn, chain_fn, carry, *rest, R=R,
                  repeats=repeats).seconds


def graph_nodes(graph) -> int:
    """The nodes of a captured torch.cuda.CUDAGraph(keep_graph=True) before
    its instantiation, counted by libcuda (cuGraphGetNodes): every kernel,
    memset and copy it holds."""
    get = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    get.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_size_t)]
    get.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    rc = get(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUDA error {rc}")
    return n.value


def _capture(fn, args):
    """fn(*args) captured as a CUDA graph (not yet instantiated): (graph,
    its output, held while the graph lives)."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = fn(*args)
    return graph, out


def _replay_ms(graph, repeats: int) -> float:
    """The median ms of `repeats` replays, each between CUDA events, after
    one replay that instantiates the graph."""
    graph.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return statistics.median(ts)


def looped(step_fn, chain_fn, carry, *rest, R: int = 64,
           repeats: int = 5) -> Looped:
    """`time_looped` with the R it used and one op's device operations.
    On a card, R is lowered (to no less than 2) where R ops would exceed
    NODE_BUDGET graph nodes."""
    if R < 2:
        raise ValueError(f"R must be >= 2 to difference, got {R}")
    leaves = tree_flatten((carry, rest))[0]
    dev = next(t.device for t in leaves if isinstance(t, torch.Tensor))
    if dev.type == "cuda":
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):  # warm-up, as torch's rule asks
            make_looped(step_fn, chain_fn, 1)(carry, *rest)
        torch.cuda.current_stream(dev).wait_stream(side)
        g1, out1 = _capture(make_looped(step_fn, chain_fn, 1),
                            (carry, *rest))
        nodes = graph_nodes(g1)
        R = max(2, min(R, NODE_BUDGET // max(nodes, 1)))
        gR, outR = _capture(make_looped(step_fn, chain_fn, R),
                            (carry, *rest))
        tR, t1 = _replay_ms(gR, repeats), _replay_ms(g1, repeats)
        del g1, gR, out1, outR
        return Looped(max(tR - t1, 1e-6) * 1e-3 / (R - 1), R, nodes)

    def med(run):
        run(carry, *rest)
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            run(carry, *rest)
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    tR = med(make_looped(step_fn, chain_fn, R))
    t1 = med(make_looped(step_fn, chain_fn, 1))
    return Looped(max(tR - t1, 1e-9) / (R - 1), R, None)


def example_problem(N: int, obs_per_knot: int, gap_s: float, dtype,
                    device, seed: int = 0):
    """(states (N, 10), BAProblem) of N knots gap_s apart with
    obs_per_knot observations each, from np.random.default_rng(seed) (the
    JAX module's recipe)."""
    from vinsat_tpu_torch.config import REFERENCE_INTRINSICS
    from vinsat_tpu_torch.estimation import ba

    M = N * obs_per_knot
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(N, 3)) * 30 + np.array([6900.0, 0, 0])
    q = rng.normal(size=(N, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    vel = rng.normal(size=(N, 3)) * 0.1 + np.array([0, 7.5, 0])
    cum = np.zeros((N, 4))
    cum[:, 3] = 1.0
    fields = dict(
        gaps=np.r_[np.full(N - 1, gap_s), 0.0], cum_rot=cum,
        landmarks_xyz=pos[rng.integers(0, N, M)] * 0.92,
        landmarks_uv=rng.uniform(0, 2000, size=(M, 2)),
        conf=rng.uniform(0.85, 1.0, M), ii=np.sort(rng.integers(0, N, M)),
        obs_valid=np.ones(M), knot_valid=np.ones(N),
        pair_valid=np.ones(N - 1), intrinsics=np.array(REFERENCE_INTRINSICS))
    states = torch.as_tensor(np.concatenate([pos, q, vel], axis=1),
                             dtype=dtype, device=device)
    return states, ba.problem_from_numpy(fields, device, dtype)


def stage_programs(params):
    """{stage: fn(states, prob, D, U, b)}, each one stage's eager program."""
    from vinsat_tpu_torch.estimation import ba, factors

    def factors_stage(states, prob, D, U, b):
        rp = factors.reprojection_factor(states, prob.landmarks_xyz,
                                         prob.ii, prob.intrinsics)
        dyn = factors.dynamics_factor(
            states, prob.gaps, prob.cum_rot, params.quat_coeff,
            params.vel_coeff, valid_pair=prob.pair_valid,
            num_hops=params.num_hops, max_substep=params.max_substep,
            with_jacobian=True)
        return rp.uv, rp.J, dyn.res_pv, dyn.A, dyn.B

    def assemble_stage(states, prob, D, U, b):
        N = states.shape[0]
        rp = factors.reprojection_factor(states, prob.landmarks_xyz,
                                         prob.ii, prob.intrinsics)
        r_obs = (prob.landmarks_uv - rp.uv) * prob.obs_valid[:, None]
        w = ba.robust_weights(r_obs, prob.conf, prob.obs_valid, 2)
        JgW = rp.J * w[:, None, None]
        G = ba._segment_sum(JgW.transpose(-1, -2) @ rp.J, prob.ii, N)
        g = ba._segment_sum((JgW.transpose(-1, -2) @ r_obs[..., None])[
            ..., 0], prob.ii, N)
        return G, g

    def solve_stage(states, prob, D, U, b):
        return ba.jacobi_scaled_tridiag_solve(D, U, b,
                                              variant=params.tridiag_variant)

    def iteration_stage(states, prob, D, U, b):
        return ba.ba_iteration(2, states, prob, 1e-4, params=params).states

    return {"factors": factors_stage, "assemble": assemble_stage,
            "solve": solve_stage, "iteration": iteration_stage}


def _solve_inputs(states, prob, stage_fns):
    """A positive-definite tridiagonal system at the problem's shape: the
    assembled G plus 10 I on the diagonal, 1e-3 A Aᵀ off it."""
    D, b = stage_fns["assemble"](states, prob, None, None, None)
    N = D.shape[0]
    gen = torch.Generator().manual_seed(0)
    A = 0.1 * torch.randn((N - 1, 9, 9), generator=gen, dtype=D.dtype)
    U = (0.01 * A @ A.transpose(-1, -2)).to(D.device)
    D = D + 10.0 * torch.eye(9, dtype=D.dtype, device=D.device)
    return D, U, b


def _time_ms(fn, args, repeats: int, warmup: int = 2) -> float:
    """ms a call of fn(*args), `repeats` calls back to back after `warmup`
    calls: CUDA events on a card, perf_counter on the CPU."""
    for _ in range(warmup):
        fn(*args)
    leaves = tree_flatten(args)[0]
    if next(t.device for t in leaves
            if isinstance(t, torch.Tensor)).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn(*args)
        return 1e3 * (time.perf_counter() - t0) / repeats
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def _looped_stage(name: str, fn, args, params, loop_R: int,
                  repeats: int) -> Tuple[Optional[Looped], Optional[str]]:
    """The stage's looped device time, each call chained to the last as the
    JAX module chains it: factors and assemble fold a sum of their outputs
    into the states, solve folds its solution into D and b (so no D-only
    work can be hoisted), iteration takes its own output states.  (None,
    why) where no graph can hold the stage."""
    states, prob, D, U, b = args
    if name == "iteration" and params.batched_lambda <= 0:
        return None, ("the sequential λ search (batched_lambda 0) reads the "
                      "host every trial; no CUDA graph holds it")
    tiny = 1e-30
    if name == "solve":
        def step(carry, U):
            return fn(states, prob, carry[0], U, carry[1])

        def chain(carry, x):
            return (carry[0] + tiny * x[:, :, None] * x[:, None, :],
                    carry[1] + tiny * x)

        return looped(step, chain, (D, b), U, R=loop_R,
                      repeats=repeats), None
    if name == "iteration":
        return looped(lambda st, p: fn(st, p, D, U, b),
                      lambda st, out: out, states, prob, R=loop_R,
                      repeats=repeats), None

    def step(st, p):
        return sum(t.sum() for t in fn(st, p, D, U, b))

    return looped(step, lambda st, s_: st + tiny * s_, states, prob,
                  R=loop_R, repeats=repeats), None


def measure(N: int, obs_per_knot: int = 8, gap_s: float = 350.0,
            dtype=torch.float32, repeats: int = 10, loop_R: int = 64,
            params=None, stages=None,
            device="cuda") -> Dict[str, Dict[str, float]]:
    """Each stage (all, or those named in `stages`) at N knots on `device`
    (a CUDA device): its looped device time a call (`device_ms`, ms; None
    with `device_note` where no graph holds the stage), the R it was
    looped at and the device operations of a call (its graph's nodes),
    its eager time a call (`eager_ms`), its counted operations and bytes,
    the rates and shares of the card's peaks they give at the device time,
    and its bound (the larger of operations over the peak FLOP/s and bytes
    over the peak bandwidth)."""
    from vinsat_tpu_torch.config import resolve_device
    from vinsat_tpu_torch.estimation import ba

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("utils.mfu measures on a CUDA device; the CPU "
                           "gives no device times")
    if params is None:
        params = ba.SolverParams(num_hops=int(np.ceil(gap_s / 100.0)) + 1,
                                 max_substep=100.0)
    fns = stage_programs(params)
    dev_in = example_problem(N, obs_per_knot, gap_s, dtype, device)
    cpu_in = example_problem(N, obs_per_knot, gap_s, dtype, "cpu")
    dev_args = (*dev_in, *_solve_inputs(*dev_in, fns))
    cpu_args = (*cpu_in, *_solve_inputs(*cpu_in, fns))
    peaks = card_peaks(torch.cuda.get_device_name(device))
    out: Dict[str, Dict[str, float]] = {}
    for name, fn in fns.items():
        if stages is not None and name not in stages:
            continue
        eager_ms = _time_ms(fn, dev_args, repeats)
        lp, note = _looped_stage(name, fn, dev_args, params, loop_R, repeats)
        ms = None if lp is None else lp.seconds * 1e3
        c = count(fn, *cpu_args)
        ops = c["matmul_flops"] + c["other_ops"]
        row = {"device_ms": ms, "eager_ms": eager_ms,
               "loop_R": None if lp is None else lp.R,
               "graph_nodes": None if lp is None else lp.nodes,
               "gflop": ops / 1e9,
               "matmul_gflop": c["matmul_flops"] / 1e9,
               "gbytes": c["bytes"] / 1e9,
               "gflop_per_s": None, "gbytes_per_s": None,
               "pct_peak_flops": None, "pct_peak_bw": None,
               "bound_ms": None, "bound_by": None}
        if note is not None:
            row["device_note"] = note
        if ms is not None:
            row.update(gflop_per_s=ops / ms / 1e6,
                       gbytes_per_s=c["bytes"] / ms / 1e6)
        if peaks is not None:
            peak = peaks[0] if dtype == torch.float64 else peaks[1]
            t_ops, t_bytes = ops / peak, c["bytes"] / peaks[2]
            row.update(bound_ms=1e3 * max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes
                       else "bytes")
            if ms is not None:
                row.update(pct_peak_flops=100.0 * t_ops / (ms * 1e-3),
                           pct_peak_bw=100.0 * t_bytes / (ms * 1e-3))
        out[name] = row
    return out


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def parser():
    """The command line: the port's flags and the JAX module's."""
    import argparse

    ap = argparse.ArgumentParser(prog="vinsat_tpu_torch.utils.mfu")
    ap.add_argument("--sizes", default="64,256,1024")
    ap.add_argument("--obs-per-knot", type=int, default=8)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--loop-r", type=int, default=64,
                    help="chained calls a looped program (fewer where the "
                         "graph would exceed NODE_BUDGET nodes)")
    ap.add_argument("--batched-lambda", type=int, default=0,
                    help="SolverParams.batched_lambda of the iteration "
                         "stage (0: the sequential λ search, which no "
                         "graph holds)")
    ap.add_argument("--stages", default=None,
                    help="comma list of stages to measure (default: all)")
    ap.add_argument("--tridiag-variant", default="auto",
                    help="SolverParams.tridiag_variant (auto|pcr|thomas|"
                         "chunked|chunked_bcr|bcr1|bcr16)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    from vinsat_tpu_torch.estimation import ba

    args = parser().parse_args(argv)
    dtype = getattr(torch, args.dtype)
    name = torch.cuda.get_device_name(torch.device(args.device)) \
        if torch.cuda.is_available() else "no CUDA device"
    peaks = card_peaks(name)
    print(json.dumps({"device": name, "nvidia_smi": _smi(),
                      "dtype": args.dtype, "loop_r": args.loop_r,
                      "batched_lambda": args.batched_lambda,
                      "tridiag_variant": args.tridiag_variant,
                      "peak_flops": None if peaks is None else
                      peaks[0 if dtype == torch.float64 else 1],
                      "peak_bytes_per_s": None if peaks is None
                      else peaks[2]}), flush=True)
    stages = args.stages.split(",") if args.stages else None
    gap_s = 350.0
    params = ba.SolverParams(
        num_hops=int(np.ceil(gap_s / 100.0)) + 1, max_substep=100.0,
        batched_lambda=args.batched_lambda,
        tridiag_variant=args.tridiag_variant)
    rows = {}
    for n in [int(s) for s in args.sizes.split(",")]:
        rep = measure(n, obs_per_knot=args.obs_per_knot, gap_s=gap_s,
                      dtype=dtype, repeats=args.repeats,
                      loop_R=args.loop_r, params=params, stages=stages,
                      device=args.device)
        for stage, row in rep.items():
            print(json.dumps({"N": n, "stage": stage, **row}), flush=True)
        rows[n] = rep
    return rows


if __name__ == "__main__":
    main()
