"""Streaming orbit determination, growing-prefix path (port of
vinsat_tpu/estimation/window.py).

Windows split on detection gaps; each window solves a growing-prefix BA
(`_solve_window`: LM iterations run to `max_iters`, returning the best-
residual iterate), states are RK4 + quaternion propagated across the gaps
between windows, and propagation / end-of-window errors are recorded for
the time-to-<5 km metric.  Eager PyTorch: the LM loop is a Python loop
whose per-iteration work stays on the device (no host sync inside a
window's solve when the λ search is batched).

Ported: the synchronous growing-prefix path with the recovery ladder's
damped retry.  The JAX package's fused async "fast" path (it hides TPU
dispatch latency and is bit-identical to the synchronous path), its f64
host-CPU escapes (no-ops for the f64 streams the port runs) and the
marginalize / prior / EKF / NEES / checkpoint modes are not: those
options raise NotImplementedError.  float64 only for now.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vinsat_tpu_torch.config import REFERENCE_INTRINSICS
from vinsat_tpu_torch.core import dynamics, quat
from vinsat_tpu_torch.estimation import ba, factors, ingest, refine


def bucket(n: int, step: int = 16, minimum: int = 16) -> int:
    """Quarter-geometric bucket >= max(n, minimum, step): the next multiple
    of max(step, 2^floor(log2(n))/4)."""
    m = max(minimum, step, n)
    p = 1 << (m - 1).bit_length()  # next pow2 >= m
    q = max(minimum, step, p // 8)  # quarter of previous pow2 tier
    return ((m + q - 1) // q) * q


def _lm_loop(step_i, states0, lamda_init, init_iters: int, num_iters: int,
             params: ba.SolverParams):
    """Run the per-window LM iteration chain.

    params.max_iters <= num_iters: exactly num_iters iterations, returning
    the LAST iterate.  Otherwise run max_iters iterations and return the
    BEST-residual iterate (the tracker resets when the vision-only init
    phase ends).  The JAX package's opt-in residual-gated early stop
    (conv_patience < the extra budget) is not ported.

    step_i(i, states, lam) -> BAStep.  Returns (states, lamda,
    last_hessian, mean_residual).
    """
    dtype, dev = states0.dtype, states0.device
    states = states0
    lam = torch.full((), float(lamda_init), dtype=dtype, device=dev)
    last_h = torch.zeros((9, 9), dtype=dtype, device=dev)
    res = torch.zeros((), dtype=dtype, device=dev)

    if params.max_iters <= num_iters:
        for i in range(num_iters):
            states, lam, last_h, res = step_i(i, states, lam)
        return states, lam, last_h, res

    if params.conv_patience < params.max_iters - num_iters:
        raise NotImplementedError(
            "residual-gated early stop (conv_patience) is not ported")
    best_states, best_h = states0, last_h
    best_res = torch.full((), math.inf, dtype=dtype, device=dev)
    for i in range(params.max_iters):
        states, lam, last_h, res = step_i(i, states, lam)
        if i == init_iters:
            best_states, best_h, best_res = states, last_h, res
        else:
            take = res < best_res
            best_states = torch.where(take, states, best_states)
            best_h = torch.where(take, last_h, best_h)
            best_res = torch.where(take, res, best_res)
    return best_states, lam, best_h, best_res


def _solve_window(states0, prob: ba.BAProblem, lamda_init, init_iters: int,
                  num_iters: int, params: ba.SolverParams = ba.SolverParams(),
                  sched_offset: int = 0):
    """LM iterations over one (padded) window; the first init_iters are
    vision-only.  Returns (states, lamda, last_hessian, mean_residual)."""

    def step_i(i, states, lam):
        return ba.ba_iteration(i + sched_offset, states, prob, lam,
                               params=params, initialize=(i < init_iters))

    return _lm_loop(step_i, states0, lamda_init, init_iters, num_iters,
                    params)


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


class StreamingConfig(NamedTuple):
    """The JAX StreamingConfig, field for field (meaning and measured
    defaults are documented there).  The port runs the growing-prefix
    mode in float64: use_prior / marginalize / use_ekf_hybrid / track_nees
    / auto_calibrate raise NotImplementedError, and recover_f64 /
    window0_init_f64 are no-ops, as they are for f64 JAX streams."""

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
    return torch.as_tensor(st, dtype=dtype, device=device), prob


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
                   intrinsics: Optional[np.ndarray] = None, device="cpu",
                   dtype=torch.float64) -> Optional[PreparedStream]:
    """Ingest + condition one detection sequence: graph build, GT
    conditioning, GT-reprojection gating, noise_level interpolation, the
    initial-noise draw (numpy Generator, the JAX package's stream of
    draws) and cumulative rotations.  None for an empty sequence."""
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


def _check_supported(cfg: StreamingConfig) -> None:
    if cfg.dtype != "float64":
        raise NotImplementedError(
            f"the torch port streams in float64 only (got {cfg.dtype!r})")
    for name in ("use_prior", "marginalize", "use_ekf_hybrid", "track_nees",
                 "auto_calibrate"):
        if getattr(cfg, name):
            raise NotImplementedError(f"StreamingConfig.{name} is not ported")


def stream_orbit(det_rows: np.ndarray, orbit_pos_eci_km: np.ndarray,
                 seed: int = 0, cfg: StreamingConfig = StreamingConfig(),
                 solver: ba.SolverParams = ba.SolverParams(),
                 intrinsics: Optional[np.ndarray] = None,
                 device="cpu") -> StreamingResult:
    """Run streaming OD on one detection sequence on `device`.

    det_rows: (M, 6) [frame, lon, lat, xc, yc, conf]; orbit_pos_eci_km:
    (T, 3) GT 1 Hz ECI positions in km.  Returns the recorded errors/times
    for the time-to-<5km evaluation.
    """
    _check_supported(cfg)
    device = torch.device(device)
    dtype = torch.float64

    def t(a, dt=dtype):
        return torch.tensor(np.asarray(a), dtype=dt, device=device)

    prep = prepare_stream(det_rows, orbit_pos_eci_km, seed, cfg,
                          intrinsics=intrinsics, device=device, dtype=dtype)
    if prep is None:
        return StreamingResult(np.array([]), np.array([]), -1,
                               np.zeros((0, 10)), np.array([], dtype=np.int64))
    if prep.states0 is None:
        return StreamingResult(np.array([]), np.array([]), -1,
                               prep.gt.states, prep.graph.time_idx)
    graph, gt, states = prep.graph, prep.gt, prep.states0
    gaps, cum_rot, knot_t, intr_np = (prep.gaps, prep.cum_rot, prep.knot_t,
                                      prep.intr_np)

    windows = ingest.split_windows(graph.ii, knot_t)

    errors: List[np.ndarray] = []
    times: List[np.ndarray] = []
    first_detection = int(knot_t[windows[0][0] - 1])
    cur_states: Optional[np.ndarray] = None  # optimized prefix
    t_prev = 0
    max_hops = int(np.ceil(gaps.max() / solver.max_substep)) + 1
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
    n_trips = 0

    def record_tail(t_init: int):
        nonlocal cur_states
        if cfg.tail_refine:
            cur_states = refine.refine_terminal(
                cur_states, gaps[:t_init], gt.landmarks_xyz, graph.uv,
                graph.conf, graph.ii, intr_np, dtype,
                max_substep=solver.max_substep,
                cum_rot=(cum_rot[:t_init] if cfg.tail_refine_rigid
                         else None),
                att_sigma=cfg.tail_refine_att_sigma,
                ratio=cfg.tail_refine_ratio, device=device)
        span = int(knot_t[-1] - knot_t[t_init - 1])
        om = gt.omega_full[knot_t[t_init - 1]:knot_t[-1]]
        path = _propagate_impl(t(cur_states[-1]), t(om), span).cpu().numpy()
        states_prop = path[knot_t[t_init:] - knot_t[t_init - 1]]
        errors.append(np.linalg.norm(
            states_prop[:, :3] - gt.states[t_init:, :3], axis=-1))
        times.append(knot_t[t_init:])

    def attempt(solve_fn, warm, prob, lamda):
        """Recovery ladder: a solve with non-finite states or a gated
        reprojection RMS above cfg.recover_rms_px is re-run from the same
        warm start with heavy damping; the best finite candidate wins,
        else the warm start.  (The JAX ladder's next rung, an f64 re-solve
        on the host, is a no-op for f64 streams.)"""
        nonlocal n_trips
        rms_gate = cfg.recover_rms_px if cfg.recover_rms_px > 0 else 0.0

        def rms_of(o):
            if not bool(torch.isfinite(o).all()):
                return math.inf
            if not rms_gate:
                return 0.0
            return float(_reproj_rms_impl(o, prob))

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
        if cands:
            return min(cands, key=lambda c: c[0])[1]
        return (warm, torch.full((), cfg.lambda_init, dtype=dtype,
                                 device=device),
                torch.zeros((9, 9), dtype=dtype, device=device),
                torch.full((), math.nan, dtype=dtype, device=device))

    for w, (t_final, i_final, seq_end) in enumerate(windows):
        solver_w = solver
        if w > 0 and _multi_pass_window(knot_t[graph.ii[:i_final]], cfg):
            solver_w = solver_later
        if w == 0:
            window_states = states[:t_final]
        else:
            # propagate from the last optimized knot across the gap
            t_init = t_prev
            span = int(knot_t[t_final - 1] - knot_t[t_init - 1])
            om = gt.omega_full[knot_t[t_init - 1]:knot_t[t_final - 1]]
            path = _propagate_impl(t(cur_states[-1]), t(om),
                                   span).cpu().numpy()
            states_prop = path[knot_t[t_init:t_final] - knot_t[t_init - 1]]
            # record propagation errors at the new knots except the last
            errors.append(np.linalg.norm(
                states_prop[:, :3] - gt.states[t_init:t_final, :3],
                axis=-1)[:-1])
            times.append(knot_t[t_init:t_final][:-1])
            window_states = np.concatenate([cur_states, states_prop], axis=0)

        # each window starts its λ schedule fresh from lambda_init
        init_iters = cfg.init_iters if w == 0 else 0
        n_pad = bucket(t_final, cfg.knot_bucket)
        m_pad = bucket(i_final, cfg.obs_bucket, cfg.obs_bucket)
        st0, prob = _pad_problem(
            window_states, gaps[:t_final], cum_rot[:t_final],
            gt.landmarks_xyz[:i_final], graph.uv[:i_final],
            graph.conf[:i_final], graph.ii[:i_final], n_pad, m_pad, device,
            dtype, intrinsics=intr_np)
        # the gap bridge runs only the hops this window's gaps use: the
        # rest are zero-length, and a zero-length hop changes nothing
        solver_w = solver_w._replace(num_hops=min(
            solver_w.num_hops,
            dynamics.active_hops(gaps[:t_final], solver_w.max_substep)))
        out_states, _, _, _ = attempt(
            lambda l0: _solve_window(st0, prob, l0, init_iters,
                                     cfg.num_iters, solver_w),
            st0, prob, cfg.lambda_init)
        cur_states = out_states[:t_final].cpu().numpy()
        t_prev = t_final

        errors.append(np.linalg.norm(
            cur_states[-1:, :3] - gt.states[t_final - 1:t_final, :3],
            axis=-1))
        times.append(knot_t[t_final - 1:t_final])

        if seq_end and t_final < len(knot_t):
            record_tail(t_final)

    return StreamingResult(
        errors=np.concatenate(errors) if errors else np.array([]),
        times=np.concatenate(times) if times else np.array([]),
        first_detection=first_detection,
        final_states=cur_states,
        knot_times=knot_t[:t_prev],
        recovery_trips=n_trips,
    )
