"""Streaming orbit determination, growing-prefix path (port of
vinsat_tpu/estimation/window.py).

Windows split on detection gaps; each window solves a growing-prefix BA
(`_solve_window`: LM iterations run to `max_iters`, returning the best-
residual iterate), states are RK4 + quaternion propagated across the gaps
between windows, and propagation / end-of-window errors are recorded for
the time-to-<5 km metric.  Eager PyTorch: the LM loop is a Python loop
whose per-iteration work stays on the device (no host sync inside a
window's solve when the λ search is batched).

`solve_window_batch` is the constellation solve (BASELINE config 4): B
padded windows in one batched LM loop, where the JAX package vmaps
`_solve_window`.

Two dispatch modes, as in the JAX package.  The async fast path
(`stream_orbit(fast=None)`, on by default in the plain growing-prefix
mode, which pipeline.run_streaming, the CLI's `stream` and the benchmark
take; `_stream_fast`): states stay on the device, window 0 solves from
its host-known start, each later window is one `_fast_window_full`
(propagation and assembly, `_prop_window_fast`; the LM solve; the end
error, health flag and RMS, `_end_stats`), the tail refinement is
chained after it, and the host reads once, at the end of the stream.  On
a card each window's solve is the replay of its captured CUDA graphs
(`_solve_window_fast`, estimation/graphs.py): one graph per distinct
iteration schedule, kept by the key JAX's jit would compile for, so a
second stream over the same arc captures nothing; the 1 Hz propagation
replays rk4_chain's captured step.  A window that comes out non-finite or
above recover_rms_px makes the whole stream run again in sync mode, and
the result says so (`sync_rerun`).  The fast path's results are the sync
path's bit for bit.

The synchronous path (fast=False, and every other mode) runs in float64
and float32, with the JAX package's recovery ladder (damped retry, then
the window solved again in f64), window 0's init phase in f64
(`window0_init_f64`), and its modes: the window-marginal prior on new
knots (`use_prior`, `solve_window_reg`), bounded windows of [anchor] +
new knots carrying the terminal marginal information (`marginalize`) and
the EKF+BA hybrid (`use_ekf_hybrid`); NEES tracking of each window's
terminal marginal (`track_nees`) and the anchor prior's inflation
calibrated from it (`auto_calibrate`); a checkpoint after every window
and the resume from one (`checkpoint_path`, `resume_from`;
utils/checkpoint's npz, the JAX package's keys); the opt-in
residual-gated early stop (SolverParams.conv_patience, `_lm_loop`).
Conditioning always runs in f64; a float32 stream solves its windows in
f32 and its f64 escapes on the same device (the JAX package sends them to
the host CPU).  A utils.metrics.MetricsLogger (`metrics`) gets a record a
window, and a utils.profiling.StageTimer (`timer`) the wall of each of
the stream's stages (prep, refine, propagate, pad_transfer, solve,
marginal), each waiting for the card before its clock stops.
"""
from __future__ import annotations

import math
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vinsat_tpu_torch.config import (DEFAULT_DEVICE, REFERENCE_INTRINSICS,
                                     resolve_device, to_device)
from vinsat_tpu_torch.core import dynamics, quat
from vinsat_tpu_torch.estimation import (ba, factors, graphs, hybrid, ingest,
                                         refine)
from vinsat_tpu_torch.evalx import calibration
from vinsat_tpu_torch.utils import checkpoint
from vinsat_tpu_torch.utils.profiling import StageTimer


def bucket(n: int, step: int = 16, minimum: int = 16) -> int:
    """Quarter-geometric bucket >= max(n, minimum, step): the next multiple
    of max(step, 2^floor(log2(n))/4)."""
    m = max(minimum, step, n)
    p = 1 << (m - 1).bit_length()  # next pow2 >= m
    q = max(minimum, step, p // 8)  # quarter of previous pow2 tier
    return ((m + q - 1) // q) * q


def _lm_iters(num_iters: int, params: ba.SolverParams) -> int:
    """Iterations `_lm_loop` runs at most."""
    return num_iters if params.max_iters <= num_iters else params.max_iters


def _early_stop(num_iters: int, params: ba.SolverParams) -> bool:
    return (params.max_iters > num_iters
            and params.conv_patience < params.max_iters - num_iters)


def _lm_start(states0, lamda_init):
    """The LM chain's carry before its first iteration: (states, λ, last
    Hessian, residual, best states, best Hessian, best residual, iterations
    since the best improved)."""
    dtype, dev = states0.dtype, states0.device
    orbits = states0.shape[:-2]
    if isinstance(lamda_init, torch.Tensor):
        lam = lamda_init.to(dtype=dtype, device=dev).expand(orbits)
    else:
        lam = torch.full(orbits, float(lamda_init), dtype=dtype, device=dev)
    last_h = torch.zeros(orbits + (9, 9), dtype=dtype, device=dev)
    res = torch.zeros(orbits, dtype=dtype, device=dev)
    best_res = torch.full(orbits, math.inf, dtype=dtype, device=dev)
    since = torch.zeros(orbits, dtype=torch.int64, device=dev)
    return states0, lam, last_h, res, states0, last_h, best_res, since


def _lm_step(i: int, carry, step_i, init_iters: int, num_iters: int,
             params: ba.SolverParams):
    """Iteration i of `_lm_loop` on its carry (`_lm_start`'s layout).  With
    the early stop, past num_iters an orbit whose best residual has not
    improved for conv_patience iterations keeps its carry."""
    states, lam, last_h, res, best_states, best_h, best_res, since = carry
    if params.max_iters <= num_iters:
        states, lam, last_h, res = step_i(i, states, lam)
        return states, lam, last_h, res, best_states, best_h, best_res, since
    early_stop = _early_stop(num_iters, params)
    active = (since < params.conv_patience
              if early_stop and i >= num_iters else None)
    states_n, lam_n, last_h, res = step_i(i, states, lam)
    if i == init_iters:
        take = torch.ones_like(res, dtype=torch.bool)
    else:
        take = res < best_res
    if early_stop:
        improved = res < best_res * (1.0 - params.conv_rtol)
        since_n = torch.where((i == init_iters) | improved,
                              torch.zeros_like(since), since + 1)
        if active is not None:
            take = take & active
            since_n = torch.where(active, since_n, since)
            states_n = torch.where(ba._along(active, states_n), states_n,
                                   states)
            lam_n = torch.where(active, lam_n, lam)
        since = since_n
    best_states = torch.where(ba._along(take, states_n), states_n,
                              best_states)
    best_h = torch.where(ba._along(take, last_h), last_h, best_h)
    best_res = torch.where(take, res, best_res)
    return states_n, lam_n, last_h, res, best_states, best_h, best_res, since


def _lm_result(carry, num_iters: int, params: ba.SolverParams):
    """(states, lamda, last_hessian, mean_residual): the last iterate of a
    fixed count, else the best."""
    states, lam, last_h, res, best_states, best_h, best_res, _ = carry
    if params.max_iters <= num_iters:
        return states, lam, last_h, res
    return best_states, lam, best_h, best_res


def _lm_loop(step_i, states0, lamda_init, init_iters: int, num_iters: int,
             params: ba.SolverParams, frozen: bool = False):
    """Run the per-window LM iteration chain.

    params.max_iters <= num_iters: exactly num_iters iterations, returning
    the LAST iterate.  Otherwise the loop runs past num_iters and returns
    the BEST-residual iterate (the tracker resets when the vision-only init
    phase ends, at i == init_iters):

      * conv_patience >= the extra budget (the default): always max_iters
        iterations;
      * conv_patience < the extra budget: the residual-gated early stop —
        iterate while i < num_iters, or while i < max_iters and the best
        residual improved by more than conv_rtol (against the best from
        before the iteration) within the last conv_patience iterations.
        The JAX package's while_loop is a host loop here that reads the
        stop condition once an iteration (one sync each).  `frozen` (the
        stream's fast path) never reads it: the loop runs to max_iters
        with each stopped orbit's carry frozen, which ends on the same
        iterate.

    step_i(i, states, lam) -> BAStep.  Returns (states, lamda,
    last_hessian, mean_residual).  states0 (B, N, 10) runs B orbits at once
    (lamda_init a float or (B,)): λ, the best-iterate tracking and the
    early stop are then per orbit, as under the JAX package's vmap — an
    orbit that has stopped keeps its carry while the others iterate, and
    the loop ends when every orbit has stopped.  One iteration is
    `_lm_step` on `_lm_start`'s carry.
    """
    carry = _lm_start(states0, lamda_init)
    for i in range(_lm_iters(num_iters, params)):
        if (not frozen and _early_stop(num_iters, params) and i >= num_iters
                and not bool((carry[7] < params.conv_patience).any())):
            break
        carry = _lm_step(i, carry, step_i, init_iters, num_iters, params)
    return _lm_result(carry, num_iters, params)


def _window_step(prob: ba.BAProblem, init_iters: int, params: ba.SolverParams,
                 sched_offset: int = 0):
    """step_i of `_lm_loop` for a window's plain LM iterations."""

    def step_i(i, states, lam):
        return ba.ba_iteration(i + sched_offset, states, prob, lam,
                               params=params, initialize=(i < init_iters))

    return step_i


def _solve_window(states0, prob: ba.BAProblem, lamda_init, init_iters: int,
                  num_iters: int, params: ba.SolverParams = ba.SolverParams(),
                  sched_offset: int = 0, frozen: bool = False):
    """LM iterations over one (padded) window; the first init_iters are
    vision-only.  Returns (states, lamda, last_hessian, mean_residual)."""
    return _lm_loop(_window_step(prob, init_iters, params, sched_offset),
                    states0, lamda_init, init_iters, num_iters, params,
                    frozen)


def solve_window(states0, prob: ba.BAProblem, lamda_init, init_iters,
                 num_iters: int, params: ba.SolverParams = ba.SolverParams(),
                 sched_offset=0):
    """The JAX package's `solve_window` (its jit of `_solve_window`) with
    its call signature: init_iters and sched_offset may be host ints or
    0-d arrays (the JAX package traces them), lamda_init a float or a 0-d
    tensor.  Returns (states, lamda, last_hessian, mean_residual)."""
    return _solve_window(states0, prob, lamda_init, int(init_iters),
                         num_iters, params, int(sched_offset))


def _lm_signature(i: int, init_iters: int, num_iters: int,
                  params: ba.SolverParams, sched_offset: int = 0) -> tuple:
    """The host values iteration i of `_solve_window` runs with besides its
    carry: two iterations of one signature run the same kernels on the
    same scalars (the fast path captures one CUDA graph for each)."""
    k = i + sched_offset
    return (ba.robust_alpha(k), ba.dynamics_sigma(k, params), i < init_iters,
            i == init_iters, _early_stop(num_iters, params) and i >= num_iters)


def _solve_window_fast(states0, prob: ba.BAProblem, lamda_init: float,
                       init_iters: int, num_iters: int,
                       params: ba.SolverParams):
    """`_solve_window` without a host read: on a card, the replay of the
    window's captured iterations (graphs.LoopProgram, kept by the key JAX's
    jit would compile for: shapes, iteration counts, λ0, SolverParams,
    dtype), else the eager loop with the early stop frozen.  The same
    iterate either way.  The batched λ search is what a graph can hold: the
    sequential one reads the host every trial."""
    if states0.device.type != "cuda":
        return _solve_window(states0, prob, lamda_init, init_iters,
                             num_iters, params, frozen=True)
    if params.batched_lambda <= 0:
        raise ValueError("a captured window solve needs the batched λ "
                         "search (SolverParams.batched_lambda > 0)")
    key = ("window", states0.device, states0.dtype, states0.shape[0],
           prob.landmarks_uv.shape[0], num_iters, init_iters,
           float(lamda_init), params, graphs.kernel_flags())

    def start(ins):
        return _lm_start(ins[0], float(lamda_init))

    def step(i, ins, carry):
        return _lm_step(i, carry, _window_step(ba.BAProblem(*ins[1:]),
                                               init_iters, params),
                        init_iters, num_iters, params)

    inputs = [states0, *prob]
    prog = graphs.program(key, lambda: graphs.LoopProgram(
        inputs, start, step, range(_lm_iters(num_iters, params)),
        lambda i: _lm_signature(i, init_iters, num_iters, params)))
    carry = prog.run(inputs)
    return tuple(t.clone() for t in _lm_result(carry, num_iters, params))


def solve_window_batch(states0_b, prob_b: ba.BAProblem, lamda_b, init_iters,
                       num_iters: int,
                       params: ba.SolverParams = ba.SolverParams(),
                       sched_offset=0):
    """The constellation solve (BASELINE config 4): B same-bucket windows
    in one batched LM loop, each ba_iteration one program over all B
    orbits (K1 solves their B systems in one launch), as the JAX
    package's vmap of `_solve_window` does.

    states0_b (B, N, 10); prob_b fields carry a leading B axis except
    intrinsics (shared; `ba.stack_problems`); lamda_b (B,).  init_iters
    and sched_offset are host ints (or 0-d arrays of one).  Returns
    (states (B, N, 10), lamda (B,), last_hessian (B, 9, 9),
    mean_residual (B,)).
    """
    return _solve_window(states0_b, prob_b, lamda_b, int(init_iters),
                         num_iters, params, int(sched_offset))


def solve_window_reg(states0, prob: ba.BAProblem, prior: ba.PriorState,
                     lamda_init, num_iters: int,
                     params: ba.SolverParams = ba.SolverParams()):
    """num_iters regularized LM iterations (ba_reg_iteration: the
    window-marginal prior factor on), the last or best iterate as in
    `_lm_loop`.  Returns (states, lamda, last_hessian, mean_residual)."""

    def step_i(i, states, lam):
        return ba.ba_reg_iteration(i, states, prob, prior, lam,
                                   params=params, initialize=False)

    return _lm_loop(step_i, states0, lamda_init, 0, num_iters, params)


def _propagate_impl(state10, omega_seq, length: int):
    """Dense 1 Hz propagation of one state (10,) over `length` steps,
    rolling the quaternion with the IMU rotations omega_seq[:length].
    Returns (length + 1, 10).  The JAX version pads to a bucketed
    max_len and masks the padded steps; here they are simply not run."""
    x0 = torch.cat([state10[:3], state10[7:10]])
    xs = dynamics.rk4_chain(x0, [1.0] * length)
    q = state10[3:7]
    if length:
        prefix = factors._inclusive_scan(quat.exp(omega_seq[:length]),
                                         quat.multiply)
        qs = torch.cat([q[None], quat.multiply(q.expand(length, 4), prefix)])
    else:
        qs = q[None]
    return torch.cat([xs[:, :3], qs, xs[:, 3:6]], dim=-1)


def propagate_segment(state10, omega_seq, length, max_len: int):
    """The JAX package's `propagate_segment` (its jit of `_propagate_impl`)
    with its signature: (max_len + 1, 10), the first min(length, max_len)
    steps run and the entries past them holding the final state."""
    steps = min(int(length), max_len)
    path = _propagate_impl(state10, omega_seq, steps)
    return torch.cat([path, path[-1:].expand(max_len - steps, 10)])


def _sq_dist_km(pos, gt_pos):
    """Squared distances (..., ) in f64 between positions (..., 3) and GT
    (..., 3), summed as numpy's norm sums: the fast path records these on
    the device, and the host takes the square roots at the stream's one
    read, so its errors are the sync path's `np.linalg.norm` bit for bit
    (torch's CPU sqrt is not always correctly rounded)."""
    d = pos.to(torch.float64) - gt_pos
    sq = d * d
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def _prop_window_fast(cur_padded, last_idx: int, omega, span: int,
                      rel_idx_pad, abs_idx_pad, t_prev: int, t_final: int,
                      gt_states, n_pad: int):
    """The fast path's step between windows, on the device (no host read):
    propagate the last optimized knot across the gap, take the propagated
    states at the new knots, their squared errors against GT, and the next
    window's padded initial states [optimized prefix | propagated new
    knots | identity padding].

    cur_padded: the previous window's padded solve output (n_prev, 10);
    omega: the IMU rates of the `span` steps (span, 3), on the device;
    rel_idx_pad[j]: position of knot t_prev + j on the propagated path;
    abs_idx_pad[j]: its row of gt_states (f64, on the device); entries at j
    >= t_final - t_prev are padding.  The host knows last_idx, span, t_prev
    and t_final (the JAX package's max_len padding is not needed: the
    propagation runs `span` steps).  Returns (st0 (n_pad, 10), err2_prop
    (n_pad,) squared km)."""
    path = _propagate_impl(cur_padded[last_idx], omega, span)
    prop = path.index_select(0, rel_idx_pad)
    err2 = _sq_dist_km(prop[:, :3],
                       gt_states.index_select(0, abs_idx_pad)[:, :3])
    pad = torch.zeros((n_pad - t_final, 10), dtype=prop.dtype,
                      device=prop.device)
    pad[:, 6] = 1.0
    st = torch.cat([cur_padded[:t_prev], prop[:t_final - t_prev], pad])
    return st, err2


def _end_stats(out, gt_states, idx: int):
    """End-of-window squared error (f64, at knot idx) and the solve-health
    flag (every state finite), on the device (fast path)."""
    return (_sq_dist_km(out[idx, :3], gt_states[idx, :3]),
            torch.isfinite(out).all())


def _fast_window_full(cur_padded, last_idx: int, omega, span: int,
                      rel_idx_pad, abs_idx_pad, t_prev: int, t_final: int,
                      gt_states, prob: ba.BAProblem, lamda: float,
                      num_iters: int, params: ba.SolverParams, n_pad: int):
    """One fast-path window > 0, enqueued without a host read: the step
    between windows (`_prop_window_fast`), the window's LM solve (on a
    card the replay of its captured iterations, `_solve_window_fast`) and
    its end statistics: the end error, the health flag and the gated
    reprojection RMS.  Returns (states, λ, err2_prop, err2_end, finite,
    rms)."""
    st0, err2_prop = _prop_window_fast(
        cur_padded, last_idx, omega, span, rel_idx_pad, abs_idx_pad, t_prev,
        t_final, gt_states, n_pad)
    out, lam_new, _, _ = _solve_window_fast(st0, prob, lamda, 0, num_iters,
                                            params)
    e2, fin = _end_stats(out, gt_states, t_final - 1)
    return out, lam_new, err2_prop, e2, fin, _reproj_rms_impl(out, prob)


class StreamingResult(NamedTuple):
    errors: np.ndarray  # (K,) km position errors at recorded times
    times: np.ndarray  # (K,) frame times of those errors
    first_detection: int
    final_states: np.ndarray  # (N, 10) final optimized knot states
    knot_times: np.ndarray  # (N,)
    window_infos: Optional[np.ndarray] = None
    window_est: Optional[np.ndarray] = None
    window_gt: Optional[np.ndarray] = None
    # windows whose FIRST solve tripped the recovery ladder
    recovery_trips: int = 0
    # the fast path found a window non-finite or above recover_rms_px and
    # this is the stream run again in sync mode
    sync_rerun: bool = False


class StreamingConfig(NamedTuple):
    """The JAX StreamingConfig, field for field (meaning and measured
    defaults are documented there).  dtype "float64" or "float32";
    recover_f64 and window0_init_f64 are no-ops on a float64 stream, as in
    JAX."""

    num_iters: int = 20
    init_iters: int = 10
    max_iters: int = 60
    max_iters_later: int = 24
    budget_span_min_s: float = 1200.0
    lambda_init: float = 1e-4
    noise_pos_km: float = 100.0
    noise_ori_rad: float = 0.2
    noise_vel_rel: float = 0.1
    prop_bucket: int = 1024
    knot_bucket: int = 16
    obs_bucket: int = 64
    dtype: str = "float64"
    use_prior: bool = False
    marginalize: bool = False
    use_ekf_hybrid: bool = False
    prior_pos_floor_km: float = 0.1
    prior_rot_floor: float = 0.01
    prior_vel_floor: float = 1e-4
    noise_level: float = 1.0
    track_nees: bool = False
    auto_calibrate: bool = False
    auto_calibrate_min_windows: int = 3
    # -1 = AUTO: batched K=9 on an accelerator, sequential on the CPU
    batched_lambda: int = -1
    tail_refine: bool = True
    tail_refine_rigid: bool = True
    tail_refine_att_sigma: float = 1e-2
    tail_refine_ratio: float = 1.3
    recover_rms_px: float = 12.0
    recover_f64: bool = True
    window0_init_f64: bool = True


def _multi_pass_window(det_t: np.ndarray, cfg: StreamingConfig) -> bool:
    """Observability proxy for the reduced iteration budget: >= 2 passes
    (detection clusters > 200 s apart) spanning >= budget_span_min_s."""
    if len(det_t) < 2:
        return False
    dt = np.unique(np.asarray(det_t, np.float64))
    if len(dt) < 2:
        return False
    passes = 1 + int((np.diff(dt) > 200.0).sum())
    return passes >= 2 and float(dt[-1] - dt[0]) >= cfg.budget_span_min_s


# cap on the per-observation residual norm entering the recover_rms_px
# signal (a few gross outliers must not trip the gate)
_RMS_CAP_PX = 64.0


def _reproj_rms_impl(states, prob: ba.BAProblem):
    """Gated-reprojection residual RMS in pixels (per-observation norms
    capped at _RMS_CAP_PX, padding masked before squaring)."""
    uv = factors.project_landmarks(states, prob.landmarks_xyz, prob.ii,
                                   prob.intrinsics)
    w = prob.obs_valid
    d = torch.where((w > 0)[:, None], uv - prob.landmarks_uv,
                    torch.zeros_like(uv))
    r2 = torch.clamp((d * d).sum(-1), max=_RMS_CAP_PX * _RMS_CAP_PX)
    return torch.sqrt((r2 * w).sum() / torch.clamp(w.sum(), min=1.0))


def _pad_prob(n: int, gaps, cum_rot, lm_xyz, lm_uv, conf, ii, n_pad: int,
              m_pad: int, device, dtype=torch.float64,
              intrinsics=None) -> ba.BAProblem:
    """Pad the host-side problem arrays to bucketed shapes (n real knots)
    and move them to `device`."""
    m = lm_uv.shape[0]
    g = np.zeros(n_pad)
    g[:n] = gaps
    cr = np.zeros((n_pad, 4))
    cr[:, 3] = 1.0
    cr[:n] = cum_rot
    lxyz = np.zeros((m_pad, 3))
    lxyz[:m] = lm_xyz
    luv = np.zeros((m_pad, 2))
    luv[:m] = lm_uv
    cf = np.zeros(m_pad)
    cf[:m] = conf
    iin = np.zeros(m_pad, dtype=np.int64)
    iin[:m] = ii
    ov = np.zeros(m_pad)
    ov[:m] = 1.0
    kv = np.zeros(n_pad)
    kv[:n] = 1.0
    pv = np.zeros(max(n_pad - 1, 1))
    pv[: max(n - 1, 0)] = 1.0
    intr = np.array(REFERENCE_INTRINSICS if intrinsics is None
                    else intrinsics)
    return ba.problem_from_numpy(
        dict(gaps=g, cum_rot=cr, landmarks_xyz=lxyz, landmarks_uv=luv,
             conf=cf, ii=iin, obs_valid=ov, knot_valid=kv, pair_valid=pv,
             intrinsics=intr), device, dtype)


def _pad_problem(states, gaps, cum_rot, lm_xyz, lm_uv, conf, ii,
                 n_pad: int, m_pad: int, device, dtype=torch.float64,
                 intrinsics=None) -> Tuple[torch.Tensor, ba.BAProblem]:
    n = states.shape[0]
    st = np.zeros((n_pad, 10))
    st[:, 6] = 1.0  # identity quats on padding
    st[:n] = states
    prob = _pad_prob(n, gaps, cum_rot, lm_xyz, lm_uv, conf, ii, n_pad, m_pad,
                     device, dtype, intrinsics=intrinsics)
    return to_device(st, dtype, device), prob


class PreparedStream(NamedTuple):
    """Conditioned stream inputs: the gated detection graph, GT, noised
    initial states, gaps and cumulative rotations.  `states0 is None` flags
    a sequence with no solvable graph."""

    graph: ingest.DetectionGraph
    gt: ingest.GroundTruth
    states0: Optional[np.ndarray]
    gaps: np.ndarray
    cum_rot: np.ndarray
    knot_t: np.ndarray
    intr_np: np.ndarray


def prepare_stream(det_rows: np.ndarray, orbit_pos_eci_km: np.ndarray,
                   seed: int, cfg: StreamingConfig,
                   intrinsics: Optional[np.ndarray] = None,
                   device=DEFAULT_DEVICE,
                   dtype=torch.float64) -> Optional[PreparedStream]:
    """Ingest + condition one detection sequence: graph build, GT
    conditioning, GT-reprojection gating, noise_level interpolation, the
    initial-noise draw (numpy Generator, the JAX package's stream of
    draws) and cumulative rotations.  None for an empty sequence."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    T = orbit_pos_eci_km.shape[0]
    if len(det_rows) == 0:
        return None
    graph = ingest.build_graph(det_rows, T)

    def t(a, dt=dtype):
        return torch.tensor(np.asarray(a), dtype=dt, device=device)

    gt = ingest.process_ground_truths(orbit_pos_eci_km, graph, device=device,
                                      dtype=dtype)
    intr_np = np.asarray(intrinsics if intrinsics is not None
                         else np.array(REFERENCE_INTRINSICS))
    uv_proj = factors.project_landmarks(
        t(gt.states), t(gt.landmarks_xyz), t(graph.ii, torch.int64),
        t(intr_np)).cpu().numpy()
    graph, gt, kept = ingest.gate_and_compact(graph, gt, uv_proj)

    N = len(graph.time_idx)
    if len(graph.ii) == 0 or N < 2:
        return PreparedStream(graph, gt, None, np.zeros(0), np.zeros(0),
                              graph.time_idx, intr_np)

    if cfg.noise_level != 1.0:
        uv_kept = uv_proj[kept]
        graph = graph._replace(
            uv=graph.uv + (uv_kept - graph.uv) * (1.0 - cfg.noise_level))

    # initial guess: GT + noise
    pos0 = gt.states[:, :3] + rng.standard_normal((N, 3)) * cfg.noise_pos_km
    phi = quat.log(t(gt.states[:, 3:7])).cpu().numpy()
    phi = phi + rng.standard_normal((N, 3)) * cfg.noise_ori_rad
    q0 = quat.exp(t(phi)).cpu().numpy()
    vel_scale = np.abs(gt.states[:, 7:10]).mean()
    vel0 = (gt.states[:, 7:10]
            + rng.standard_normal((N, 3)) * vel_scale * cfg.noise_vel_rel)
    states = np.concatenate([pos0, q0, vel0], axis=1)

    knot_t = graph.time_idx
    gaps = np.concatenate([np.diff(knot_t), [0]]).astype(np.float64)
    cum_rot = factors.cumulative_rotations(
        t(gt.omega_full), 1.0, t(knot_t, torch.int64)).cpu().numpy()
    return PreparedStream(graph, gt, states, gaps, cum_rot, knot_t, intr_np)


_DTYPES = {"float64": torch.float64, "float32": torch.float32}


def _check_supported(cfg: StreamingConfig) -> None:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"StreamingConfig.dtype must be one of "
                         f"{sorted(_DTYPES)}, got {cfg.dtype!r}")


def compose_prior_blocks(H9: np.ndarray):
    """Split a 9x9 [pos, phi, vel] information matrix into prior_factor's
    (H_state [pos, vel] (6, 6), H_rot [phi] (3, 3)) blocks, and the 9x9
    matrix recomposed from just those blocks (the anchor's extra_diag for
    terminal_marginal_info)."""
    Hs, Hr = ba.split_info(H9)
    H9c = np.zeros((9, 9))
    H9c[np.ix_(ba.POS_VEL, ba.POS_VEL)] = Hs
    H9c[3:6, 3:6] = Hr
    return Hs, Hr, H9c


def _padded_prior(n_pad: int, a: int, prop: np.ndarray, Hs: np.ndarray,
                  Hr: np.ndarray, device, dtype) -> ba.PriorState:
    """A PriorState over n_pad knots carrying `prop` / Hs / Hr on knots
    [a, a + len(prop)) and no information elsewhere."""
    b = a + len(prop)
    prop_pad = np.zeros((n_pad, 10))
    prop_pad[:, 6] = 1.0
    prop_pad[a:b] = prop
    Hs_pad = np.zeros((n_pad, 6, 6))
    Hs_pad[a:b] = Hs
    Hr_pad = np.zeros((n_pad, 3, 3))
    Hr_pad[a:b] = Hr
    val = np.zeros(n_pad)
    val[a:b] = 1.0
    return ba.PriorState(*(torch.as_tensor(x, dtype=dtype, device=device)
                           for x in (prop_pad, Hs_pad, Hr_pad, val)))


def _cast(tup, dtype):
    """A NamedTuple of tensors with its floating fields cast to dtype."""
    return type(tup)(*(x.to(dtype) if x.is_floating_point() else x
                       for x in tup))


def _solve_window_f64(st0, prob: ba.BAProblem, lamda0, init_iters: int,
                      num_iters: int, params: ba.SolverParams,
                      prior: Optional[ba.PriorState] = None):
    """The recovery ladder's f64 rung: the same padded window (and prior)
    cast up and solved again in f64, on the device it lies on (the JAX
    package goes to the host CPU; the card has an f64 rate).  Returns the
    f64 (states, lamda, last_hessian, mean_residual), or None when the
    window is already f64 (nothing to escalate to)."""
    if st0.dtype == torch.float64:
        return None
    st64, prob64 = st0.to(torch.float64), _cast(prob, torch.float64)
    if prior is not None:
        return solve_window_reg(st64, prob64, _cast(prior, torch.float64),
                                float(lamda0), num_iters, params)
    return _solve_window(st64, prob64, float(lamda0), int(init_iters),
                         num_iters, params)


def _window0_init_f64(st0, prob: ba.BAProblem, lamda0, init_iters: int,
                      params: ba.SolverParams):
    """Window 0's init phase in f64 (StreamingConfig.window0_init_f64):
    init_iters vision-only and 10 full LM iterations at a fixed count
    with the sequential λ search, through _solve_window_f64.  Returns the
    f64 warm-start states, or None for an f64 window or a non-finite
    result."""
    r = _solve_window_f64(st0, prob, lamda0, init_iters, int(init_iters) + 10,
                          params._replace(max_iters=0, batched_lambda=0))
    if r is None or not bool(torch.isfinite(r[0]).all()):
        return None
    return r[0]


def _new_knot_rows(knot_t: np.ndarray, a: int, b: int, n_pad: int):
    """Host index rows of knots [a, b) for `_prop_window_fast`: each one's
    step on the path propagated from knot a - 1, and its own row; zero
    past b - a."""
    rel = np.zeros(n_pad, np.int64)
    rel[:b - a] = knot_t[a:b] - knot_t[a - 1]
    absi = np.zeros(n_pad, np.int64)
    absi[:b - a] = np.arange(a, b)
    return rel, absi


def _window_setup(prep: PreparedStream, cfg: StreamingConfig,
                  solver: ba.SolverParams, solver_later: ba.SolverParams,
                  w: int, t_final: int, i_final: int, device, dtype,
                  window_states: Optional[np.ndarray] = None, first: int = 0,
                  i_first: int = 0, later: bool = True):
    """The setup of window w that both dispatch modes share: its solver
    (the reduced later budget for a multi-pass window when `later`, the
    gap bridge's hops cut to those its gaps use: the rest are zero-length,
    and a zero-length hop changes nothing), n_pad, and the padded problem
    of knots [first, t_final) and observations [i_first, i_final), with
    window_states (knots first..) padded beside it when given.  Returns
    (solver_w, n_pad, st0 or None, prob)."""
    graph, gaps = prep.graph, prep.gaps
    solver_w = solver
    if later and w > 0 and _multi_pass_window(
            prep.knot_t[graph.ii[:i_final]], cfg):
        solver_w = solver_later
    n_pad = bucket(t_final - first, cfg.knot_bucket)
    m_pad = bucket(max(i_final - i_first, 1), cfg.obs_bucket,
                   cfg.obs_bucket)
    obs = slice(i_first, i_final)
    args = (gaps[first:t_final], prep.cum_rot[first:t_final],
            prep.gt.landmarks_xyz[obs], graph.uv[obs], graph.conf[obs],
            graph.ii[obs] - first, n_pad, m_pad, device, dtype)
    if window_states is None:
        st0, prob = None, _pad_prob(t_final - first, *args,
                                    intrinsics=prep.intr_np)
    else:
        st0, prob = _pad_problem(window_states, *args,
                                 intrinsics=prep.intr_np)
    solver_w = solver_w._replace(num_hops=min(
        solver_w.num_hops,
        dynamics.active_hops(gaps[first:t_final], solver_w.max_substep)))
    return solver_w, n_pad, st0, prob


def _window0_start(st0, prob: ba.BAProblem, cfg: StreamingConfig,
                   solver_w: ba.SolverParams, dtype):
    """Window 0's start and vision-only iterations: with
    cfg.window0_init_f64, the f64 init phase's result and none left."""
    if cfg.window0_init_f64:
        o64 = _window0_init_f64(st0, prob, cfg.lambda_init, cfg.init_iters,
                                solver_w)
        if o64 is not None:
            return o64.to(dtype), 0
    return st0, cfg.init_iters


def _refine_tail(states, prep: PreparedStream, cfg: StreamingConfig,
                 solver: ba.SolverParams, t_init: int):
    """The tail refinement of the solved knots [0, t_init), states on the
    device (refine.refine_terminal_device)."""
    graph = prep.graph
    return refine.refine_terminal_device(
        states, prep.gaps[:t_init], prep.gt.landmarks_xyz, graph.uv,
        graph.conf, graph.ii, prep.intr_np, max_substep=solver.max_substep,
        cum_rot=(prep.cum_rot[:t_init] if cfg.tail_refine_rigid else None),
        att_sigma=cfg.tail_refine_att_sigma, ratio=cfg.tail_refine_ratio)


def _stream_fast(prep: PreparedStream, windows, cfg: StreamingConfig,
                 solver: ba.SolverParams, solver_later: ba.SolverParams,
                 device, dtype) -> Optional[StreamingResult]:
    """`stream_orbit`'s async fast path: the states stay on the device,
    window 0 solves from its host-known start (and, in f32, its f64 init
    phase), each later window is one `_fast_window_full`, the tail
    refinement and propagation are chained after the last window, and the
    recorded errors, health flags, RMS and final states come back in one
    host read at the end.  Uploads come from pinned memory, so the host
    never waits for the device before that read.  Returns None when a
    window's solve was non-finite or its RMS above cfg.recover_rms_px (the
    caller runs the stream again in sync mode)."""
    gt, knot_t = prep.gt, prep.knot_t

    def t(a, dt=dtype):
        return to_device(a, dt, device)

    gt_dev = t(gt.states, torch.float64)
    sq_errs: List[Tuple[torch.Tensor, int]] = []  # (squared km, kept)
    times: List[np.ndarray] = []
    checks: List[torch.Tensor] = []  # each window's finite flag and RMS
    t_prev = 0
    for w, (t_final, i_final, seq_end) in enumerate(windows):
        solver_w, n_pad, st0, prob = _window_setup(
            prep, cfg, solver, solver_later, w, t_final, i_final, device,
            dtype, window_states=prep.states0[:t_final] if w == 0 else None)
        if w == 0:
            st0, init_iters = _window0_start(st0, prob, cfg, solver_w, dtype)
            out = _solve_window_fast(st0, prob, cfg.lambda_init, init_iters,
                                     cfg.num_iters, solver_w)[0]
            e2, fin = _end_stats(out, gt_dev, t_final - 1)
            rms = _reproj_rms_impl(out, prob)
        else:
            rel, absi = _new_knot_rows(knot_t, t_prev, t_final, n_pad)
            om = gt.omega_full[knot_t[t_prev - 1]:knot_t[t_final - 1]]
            out, _, err2, e2, fin, rms = _fast_window_full(
                out, t_prev - 1, t(om), int(knot_t[t_final - 1]
                                            - knot_t[t_prev - 1]),
                t(rel, torch.int64), t(absi, torch.int64), t_prev, t_final,
                gt_dev, prob, cfg.lambda_init, cfg.num_iters, solver_w, n_pad)
            # propagation errors at the new knots except the last
            sq_errs.append((err2, t_final - t_prev - 1))
            times.append(knot_t[t_prev:t_final][:-1])
        sq_errs.append((e2, 1))
        times.append(knot_t[t_final - 1:t_final])
        checks += [fin, rms]
        t_prev = t_final
        final = out[:t_final]
        if seq_end and t_final < len(knot_t):
            # the tail: refined, then propagated to the arc's end
            if cfg.tail_refine:
                final = _refine_tail(final, prep, cfg, solver, t_final)
            n_tail = len(knot_t) - t_final
            rel, absi = _new_knot_rows(knot_t, t_final, len(knot_t),
                                       bucket(n_tail, cfg.knot_bucket))
            _, err2 = _prop_window_fast(
                final, t_final - 1,
                t(gt.omega_full[knot_t[t_final - 1]:knot_t[-1]]),
                int(knot_t[-1] - knot_t[t_final - 1]), t(rel, torch.int64),
                t(absi, torch.int64), 0, 0, gt_dev, len(rel))
            sq_errs.append((err2, n_tail))
            times.append(knot_t[t_final:])

    # the stream's one host read
    parts = [e for e, _ in sq_errs] + checks + [final]
    flat = torch.cat([p.reshape(-1).to(torch.float64)
                      for p in parts]).cpu().numpy()
    cuts = np.cumsum([p.numel() for p in parts])[:-1]
    host = np.split(flat, cuts)
    fins, rmss = host[len(sq_errs):-1:2], host[len(sq_errs) + 1:-1:2]
    if not all(bool(f[0]) for f in fins) or (cfg.recover_rms_px > 0 and any(
            not np.isfinite(r[0]) or r[0] > cfg.recover_rms_px
            for r in rmss)):
        return None
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return StreamingResult(
        errors=np.concatenate([np.sqrt(e[:k]) for e, (_, k)
                               in zip(host, sq_errs)]),
        times=np.concatenate(times),
        first_detection=int(knot_t[windows[0][0] - 1]),
        final_states=host[-1].reshape(-1, 10).astype(np_dtype),
        knot_times=knot_t[:t_prev])


def stream_orbit(det_rows: np.ndarray, orbit_pos_eci_km: np.ndarray,
                 seed: int = 0, cfg: StreamingConfig = StreamingConfig(),
                 solver: ba.SolverParams = ba.SolverParams(),
                 intrinsics: Optional[np.ndarray] = None,
                 metrics=None, checkpoint_path=None, resume_from=None,
                 timer: Optional[StageTimer] = None,
                 fast: Optional[bool] = None,
                 device=DEFAULT_DEVICE) -> StreamingResult:
    """Run streaming OD on one detection sequence on `device`.  The
    parameters it shares with the JAX package's stream_orbit come in that
    function's order; `device` follows them.

    det_rows: (M, 6) [frame, lon, lat, xc, yc, conf]; orbit_pos_eci_km:
    (T, 3) GT 1 Hz ECI positions in km.  Returns the recorded errors/times
    for the time-to-<5km evaluation.  Conditioning runs in f64 whatever
    cfg.dtype; the windows are solved in cfg.dtype.

    checkpoint_path: after every window, its state is written to
    `{checkpoint_path}.w{w}.npz` (utils/checkpoint).  resume_from: such a
    file, from either package; the windows up to and including its own are
    restored (states, trailing Hessian, λ, recorded errors, the bounded
    mode's anchor information and the NEES history) instead of solved, and
    the run goes on from the next window with the results of an
    uninterrupted one (the window split and the initial-noise draw are
    deterministic in det_rows / seed).

    metrics: a utils.metrics.MetricsLogger; each solved window logs
    log_window (knots, observations, mean residual, λ, the wall since the
    previous window's record, the end error) and, with NEES tracking, a
    "nees" record.  timer: a utils.profiling.StageTimer accumulating each
    stream stage's wall; its stages synchronize the device, so it costs
    a wait a stage.  Neither changes a result.

    fast: the async dispatch (None = auto, the JAX package's rule).  The
    plain growing-prefix mode qualifies (no checkpoint or resume, no
    metrics, no timer, no prior, not bounded, no NEES tracking; on a card
    also the batched λ search, which is the card's default: the
    sequential one reads the host every trial), and fast=True outside it
    runs the sync path.  The fast path (`_stream_fast`) reads the host
    once, at the end of the stream; the results are the sync path's bit
    for bit.  When a window's solve came out non-finite, or fit its own
    observations worse than cfg.recover_rms_px, the stream runs again with
    fast=False, whose per-window recovery ladder handles it, and that
    result (its recovery_trips included) is returned with sync_rerun=True.
    """
    _check_supported(cfg)
    device = resolve_device(device)
    dtype = _DTYPES[cfg.dtype]
    # a discarded timer keeps the stage blocks unconditional; only a
    # caller's timer waits for the device
    sync = device if timer is not None else None
    timer = StageTimer() if timer is None else timer
    t_log = time.time()

    def t(a, dt=dtype):
        return torch.tensor(np.asarray(a), dtype=dt, device=device)

    # conditioning in f64: in f32 it costs km of final error (the JAX
    # package measured 0.39 -> 6.5 km on the bench arc)
    with timer.stage("prep", sync):
        prep = prepare_stream(det_rows, orbit_pos_eci_km, seed, cfg,
                              intrinsics=intrinsics, device=device,
                              dtype=torch.float64)
    if prep is None:
        return StreamingResult(np.array([]), np.array([]), -1,
                               np.zeros((0, 10)), np.array([], dtype=np.int64))
    if prep.states0 is None:
        return StreamingResult(np.array([]), np.array([]), -1,
                               prep.gt.states, prep.graph.time_idx)
    graph, gt, states = prep.graph, prep.gt, prep.states0
    # the intrinsics reach the solve cast to its dtype (_pad_problem), as
    # the JAX package casts them
    gaps, cum_rot, knot_t, intr_np = (prep.gaps, prep.cum_rot, prep.knot_t,
                                      prep.intr_np)

    windows = ingest.split_windows(graph.ii, knot_t)

    errors: List[np.ndarray] = []
    times: List[np.ndarray] = []
    first_detection = int(knot_t[windows[0][0] - 1])
    cur_states: Optional[np.ndarray] = None  # optimized prefix
    last_hessian: Optional[np.ndarray] = None
    prior_full = None  # (prop_states, H_state, H_rot, t_init)
    marg_info: Optional[np.ndarray] = None  # (9, 9) anchor information
    t_prev = 0
    i_prev = 0
    max_hops = int(np.ceil(gaps.max() / solver.max_substep)) + 1
    solver_in = solver  # the caller's, for a sync re-run of a fast stream
    solver = solver._replace(
        num_hops=max(solver.num_hops, max_hops),
        max_iters=solver.max_iters if solver.max_iters > 0
        else cfg.max_iters)
    if solver.batched_lambda == 0 and cfg.batched_lambda != 0:
        if cfg.batched_lambda > 0:
            solver = solver._replace(batched_lambda=cfg.batched_lambda)
        elif device.type != "cpu":
            # AUTO: batched λ search on the accelerator, sequential on CPU
            solver = solver._replace(batched_lambda=9)
    solver_later = solver
    if cfg.max_iters_later > 0 and solver.max_iters > 0:
        solver_later = solver._replace(
            max_iters=min(solver.max_iters, max(cfg.max_iters_later,
                                                cfg.num_iters + 1)))
    bounded = cfg.marginalize or cfg.use_ekf_hybrid
    track = cfg.track_nees or (cfg.auto_calibrate and bounded)
    # async fast path: only the plain growing-prefix mode qualifies (every
    # other mode needs host values between windows)
    fast_ok = (checkpoint_path is None and resume_from is None
               and metrics is None and sync is None and not cfg.use_prior
               and not bounded and not track
               and (device.type != "cuda" or solver.batched_lambda > 0))
    if (fast_ok if fast is None else bool(fast) and fast_ok):
        res = _stream_fast(prep, windows, cfg, solver, solver_later, device,
                           dtype)
        if res is not None:
            return res
        return stream_orbit(det_rows, orbit_pos_eci_km, seed=seed, cfg=cfg,
                            solver=solver_in, intrinsics=intrinsics,
                            device=device, fast=False)._replace(
                                sync_rerun=True)
    n_trips = 0
    # NEES samples: each window's terminal marginal, estimate and GT
    nees_infos: List[np.ndarray] = []
    nees_est: List[np.ndarray] = []
    nees_gt: List[np.ndarray] = []

    start_w = 0
    if resume_from is not None:
        ck = checkpoint.load(resume_from)
        start_w = ck["window_idx"] + 1
        cur_states = ck["states"]
        last_hessian = ck["last_hessian"]
        errors, times = [ck["errors"]], [ck["times"]]
        t_prev = len(ck["knot_times"])
        if "marg_info" in ck:
            marg_info = np.asarray(ck["marg_info"])
            i_prev = int(ck["i_prev"])
        if "nees_infos" in ck:
            # auto_calibrate derives the anchor's inflation from this
            # history, so a resumed run needs it to match an unbroken one
            nees_infos = list(np.asarray(ck["nees_infos"]))
            nees_est = list(np.asarray(ck["nees_est"]))
            nees_gt = list(np.asarray(ck["nees_gt"]))

    def anchor_info(H9: np.ndarray) -> np.ndarray:
        """The anchor prior's information: inflated by the measured NEES
        factors (each at least 1) once auto-calibration has enough
        windows, else the static covariance floors."""
        if (cfg.auto_calibrate
                and len(nees_infos) >= cfg.auto_calibrate_min_windows):
            c = calibration.calibrate_inflation(nees_infos, nees_est,
                                                nees_gt)
            return calibration.apply_inflation(
                H9, {k: max(v, 1.0) for k, v in c.items()})
        return ba.inflate_info(H9, cfg.prior_pos_floor_km,
                               cfg.prior_rot_floor, cfg.prior_vel_floor)

    def record_tail(t_init: int):
        nonlocal cur_states
        if cfg.tail_refine:
            with timer.stage("refine", sync):
                cur_states = _refine_tail(t(cur_states), prep, cfg, solver,
                                          t_init).cpu().numpy()
        span = int(knot_t[-1] - knot_t[t_init - 1])
        om = gt.omega_full[knot_t[t_init - 1]:knot_t[-1]]
        with timer.stage("propagate", sync):
            path = _propagate_impl(t(cur_states[-1]), t(om),
                                   span).cpu().numpy()
        states_prop = path[knot_t[t_init:] - knot_t[t_init - 1]]
        errors.append(np.linalg.norm(
            states_prop[:, :3] - gt.states[t_init:, :3], axis=-1))
        times.append(knot_t[t_init:])

    def attempt(solve_fn, warm, lamda, ctx):
        """Recovery ladder: a solve with non-finite states or a gated
        reprojection RMS above cfg.recover_rms_px is re-run from the same
        warm start with heavy damping; if still bad and cfg.recover_f64,
        an f32 window is solved again in f64 (_solve_window_f64), whose
        result is cast back and competes on RMS like the others.  The
        best finite candidate wins, else the warm start.
        ctx = (st0, prob, prior, init_iters, params) of the window."""
        nonlocal n_trips
        rms_gate = cfg.recover_rms_px if cfg.recover_rms_px > 0 else 0.0

        def rms_of(o):
            if not bool(torch.isfinite(o).all()):
                return math.inf
            if not rms_gate:
                return 0.0
            return float(_reproj_rms_impl(o, ctx[1]))

        cands = []
        for rung, lam0 in enumerate((lamda, 1e2)):
            out = solve_fn(lam0)
            r = rms_of(out[0])
            if r <= rms_gate:
                return out
            if rung == 0:
                n_trips += 1
            if math.isfinite(r):
                cands.append((r, out))
        if cfg.recover_f64:
            st0_c, prob_c, prior_c, init_c, params_c = ctx
            r64 = _solve_window_f64(st0_c, prob_c, lamda, init_c,
                                    cfg.num_iters, params_c, prior=prior_c)
            if r64 is not None and bool(torch.isfinite(r64[0]).all()):
                out = tuple(x.to(dtype) for x in r64)
                cands.append((rms_of(out[0]), out))
        good = [c for c in cands if math.isfinite(c[0])]
        if good:
            return min(good, key=lambda c: c[0])[1]
        return (warm, torch.full((), cfg.lambda_init, dtype=dtype,
                                 device=device),
                torch.zeros((9, 9), dtype=dtype, device=device),
                torch.full((), math.nan, dtype=dtype, device=device))

    for w, (t_final, i_final, seq_end) in enumerate(windows):
        if w < start_w:
            # restored from the checkpoint: only the final window's tail
            # (recorded after its checkpoint was written) remains
            if seq_end and t_prev < len(knot_t):
                record_tail(t_prev)
            continue
        sub_anchor: Optional[int] = None
        if w == 0:
            window_states = states[:t_final]
        else:
            # propagate from the last optimized knot across the gap
            t_init = t_prev
            span = int(knot_t[t_final - 1] - knot_t[t_init - 1])
            om = gt.omega_full[knot_t[t_init - 1]:knot_t[t_final - 1]]
            with timer.stage("propagate", sync):
                path = _propagate_impl(t(cur_states[-1]), t(om),
                                       span).cpu().numpy()
            states_prop = path[knot_t[t_init:t_final] - knot_t[t_init - 1]]
            # record propagation errors at the new knots except the last
            errors.append(np.linalg.norm(
                states_prop[:, :3] - gt.states[t_init:t_final, :3],
                axis=-1)[:-1])
            times.append(knot_t[t_init:t_final][:-1])
            if bounded and marg_info is not None:
                # bounded-memory window: [anchor] + new knots
                sub_anchor = t_prev - 1
                new_states = states_prop
                if cfg.use_ekf_hybrid:
                    gap_max = float((knot_t[t_init:t_final]
                                     - knot_t[t_init - 1:t_final - 1]).max())
                    new_states = hybrid.ekf_refine_window(
                        cur_states[-1], anchor_info(marg_info), knot_t,
                        t_init, t_final, cum_rot, graph, gt, intr_np, dtype,
                        num_hops=int(np.ceil(gap_max / solver.max_substep))
                        + 1, max_substep=solver.max_substep, device=device)
                window_states = np.concatenate([cur_states[-1:], new_states],
                                               axis=0)
            else:
                window_states = np.concatenate([cur_states, states_prop],
                                               axis=0)
                if cfg.use_prior:
                    # window-marginal prior on the newly propagated knots
                    spans = (knot_t[t_init:t_final]
                             - knot_t[t_init - 1]).astype(np.float64)
                    pri = ba.propagate_prior(
                        t(cur_states[-1]), t(last_hessian), t(spans),
                        factors.span_rotations(
                            t(gt.omega_full), 1.0, int(knot_t[t_init - 1]),
                            t(knot_t[t_init:t_final], torch.int64)),
                        num_hops=int(np.ceil(spans.max()
                                             / solver.max_substep)) + 1,
                        max_substep=solver.max_substep)
                    prior_full = (pri.prop_states.cpu().numpy(),
                                  pri.H_state.cpu().numpy(),
                                  pri.H_rot.cpu().numpy(), t_init)

        # each window starts its λ schedule fresh from lambda_init
        lamda = cfg.lambda_init
        init_iters = cfg.init_iters if w == 0 else 0
        first = 0 if sub_anchor is None else sub_anchor
        i_first = 0 if sub_anchor is None else i_prev
        with timer.stage("pad_transfer", sync):
            # the reduced budget needs >= 2 passes in the solved span;
            # bounded windows are anchor + one pass and always take the
            # full budget
            solver_w, n_pad, st0, prob = _window_setup(
                prep, cfg, solver, solver_later, w, t_final, i_final, device,
                dtype, window_states=window_states, first=first,
                i_first=i_first, later=not bounded)
        prior = None
        extra_diag0 = None
        if sub_anchor is not None:
            Hs0, Hr0, extra_diag0 = compose_prior_blocks(
                anchor_info(marg_info))
            prior = _padded_prior(n_pad, 0, cur_states[-1:], Hs0[None],
                                  Hr0[None], device, dtype)
        else:
            if w == 0:
                st0, init_iters = _window0_start(st0, prob, cfg, solver_w,
                                                 dtype)
            if cfg.use_prior and w > 0 and prior_full is not None:
                ps, hs, hr, a = prior_full
                prior = _padded_prior(n_pad, a, ps, hs, hr, device, dtype)
        with timer.stage("solve", sync):
            if prior is None:
                out = attempt(
                    lambda l0: _solve_window(st0, prob, l0, init_iters,
                                             cfg.num_iters, solver_w),
                    st0, lamda, (st0, prob, None, init_iters, solver_w))
            else:
                out = attempt(
                    lambda l0: solve_window_reg(st0, prob, prior, l0,
                                                cfg.num_iters, solver_w),
                    st0, lamda, (st0, prob, prior, 0, solver_w))
            out_states, lam_w, last_h, mean_res = out
            out_np = out_states[:t_final - first].cpu().numpy()
        if sub_anchor is None:
            cur_states = out_np
        else:
            cur_states = np.concatenate([cur_states[:-1], out_np], axis=0)
        last_hessian = last_h.cpu().numpy()
        t_prev, i_prev = t_final, i_final

        if bounded or track:
            # the terminal marginal information of the window just solved
            # (Schur complement): the next window's anchor prior, and the
            # NEES sample
            extra = np.zeros((n_pad, 9, 9))
            if extra_diag0 is not None:
                extra[0] = extra_diag0
            with timer.stage("marginal", sync):
                info_w = ba.terminal_marginal_info(
                    out_states, prob, solver_w, extra_diag=t(extra)
                ).cpu().numpy().astype(np.float64)
            if bounded:
                marg_info = info_w
            if track:
                nees_infos.append(info_w)
                nees_est.append(cur_states[-1].copy())
                gt_t = gt.states[t_final - 1].copy()
                # gt.states' knot velocities are forward differences, and
                # the sequence's last knot has none: the central
                # difference of the 1 Hz GT orbit instead
                ti = int(knot_t[t_final - 1])
                lo = max(ti - 1, 0)
                hi = min(ti + 1, orbit_pos_eci_km.shape[0] - 1)
                gt_t[7:10] = ((orbit_pos_eci_km[hi] - orbit_pos_eci_km[lo])
                              / max(hi - lo, 1))
                nees_gt.append(gt_t)
                if metrics is not None:
                    metrics.log("nees", window=w, **calibration.block_nees(
                        nees_est[-1], nees_gt[-1], info_w))

        end_err = np.linalg.norm(
            cur_states[-1:, :3] - gt.states[t_final - 1:t_final, :3],
            axis=-1)
        errors.append(end_err)
        times.append(knot_t[t_final - 1:t_final])

        if metrics is not None:
            now = time.time()
            metrics.log_window(
                window_idx=w, num_knots=t_final, num_obs=i_final,
                mean_residual=float(mean_res), lamda=float(lam_w),
                wall_s=now - t_log, end_error_km=float(end_err[0]))
            t_log = now

        if checkpoint_path is not None:
            ck_extra = ({} if marg_info is None
                        else {"marg_info": marg_info,
                              "i_prev": np.array(i_prev)})
            if track and nees_infos:
                ck_extra.update(nees_infos=np.asarray(nees_infos),
                                nees_est=np.asarray(nees_est),
                                nees_gt=np.asarray(nees_gt))
            checkpoint.save(
                f"{checkpoint_path}.w{w}.npz", states=cur_states,
                last_hessian=last_hessian, window_idx=w, lamda=float(lam_w),
                knot_times=knot_t[:t_final], errors=np.concatenate(errors),
                times=np.concatenate(times), extra=ck_extra)

        if seq_end and t_final < len(knot_t):
            record_tail(t_final)

    return StreamingResult(
        errors=np.concatenate(errors) if errors else np.array([]),
        times=np.concatenate(times) if times else np.array([]),
        first_detection=first_detection,
        final_states=cur_states,
        knot_times=knot_t[:t_prev],
        window_infos=np.asarray(nees_infos) if nees_infos else None,
        window_est=np.asarray(nees_est) if nees_est else None,
        window_gt=np.asarray(nees_gt) if nees_gt else None,
        recovery_trips=n_trips,
    )
