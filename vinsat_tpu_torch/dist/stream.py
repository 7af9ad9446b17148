"""The sharded stream (BASELINE config 5(b); port of
vinsat_tpu/dist/stream.py): windows sequenced on the host, each window's
knots split over the mesh's arc shards.

It is `window.stream_orbit`'s sync path (the same prep, window split,
propagation between windows, λ schedule, iteration budget and error
recording) with every window solved by
`sharded_ba.make_sharded_window_solver`: growing-prefix windows, or bounded
ones (`marginalize`: the anchor knot carrying the terminal marginal as a
sharded BA_reg prior).

Layout:
  * observations use the per-knot budget (N, D, ...) of ShardedProblem; D
    is the window's most detections on one knot rounded up to a power of
    two (`d_pad`), so no observation is dropped;
  * a window with fewer bucketed knots than `shard_min_knots` solves on
    one shard (a 1x1 mesh on the same device); a larger one pads its
    bucketed size to a multiple of the arc size and splits over the arc
    shards;
  * the propagation between windows and the terminal-marginal Schur
    complement run unsharded — they are O(window).

Conditioning runs in f64 and the windows in cfg.dtype, as in
`window.stream_orbit`; window 0's f64 init (`window0_init_f64`) runs on the
mesh's device.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from vinsat_tpu_torch.core import dynamics
from vinsat_tpu_torch.dist import mesh as mesh_mod
from vinsat_tpu_torch.dist import sharded_ba
from vinsat_tpu_torch.estimation import ba, ingest, refine
from vinsat_tpu_torch.estimation.window import (
    _DTYPES, StreamingConfig, StreamingResult, _check_supported,
    _multi_pass_window, _pad_problem, _propagate_impl, _window0_init_f64,
    bucket, compose_prior_blocks, prepare_stream)

# A window shards over the arc axis only at or above this many (bucketed)
# knots; below it the whole window solves on one shard.  The JAX package's
# measured crossover on its 8-device CPU mesh (one device wins up to 128
# knots, sharding from 256).
SHARD_MIN_KNOTS_DEFAULT = 256


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pow2(n: int, minimum: int = 2) -> int:
    return max(minimum, 1 << (max(n, 1) - 1).bit_length())


def _build_window_problem(states_w, gaps_w, cum_w, lm_w, uv_w, conf_w, ii_w,
                          n_pad: int, d_pad: int, intr_np, dtype,
                          n_arc: int = 1, device="cpu"
                          ) -> sharded_ba.ShardedProblem:
    """Ragged window slice -> per-knot-budget ShardedProblem (B = 1) over
    n_arc shards on `device`.  ii_w is window-local (0-based); every
    knot's observations fill its slots in the order they come, and d_pad
    must hold the most of any knot."""
    n = states_w.shape[0]
    st = np.zeros((n_pad, 10))
    st[:, 6] = 1.0
    st[:n] = states_w
    g = np.zeros(n_pad)
    g[:n] = gaps_w
    cr = np.zeros((n_pad, 4))
    cr[:, 3] = 1.0
    cr[:n] = cum_w

    ii_w = np.asarray(ii_w, np.int64)
    # slot of each observation: its rank among its knot's, in order
    order = np.argsort(ii_w, kind="stable")
    ii_sorted = ii_w[order]
    slot = np.empty_like(ii_w)
    slot[order] = (np.arange(len(ii_w))
                   - np.searchsorted(ii_sorted, ii_sorted, side="left"))
    if len(ii_w) and slot.max() >= d_pad:
        raise ValueError(f"a knot holds {slot.max() + 1} observations, the "
                         f"budget d_pad is {d_pad}")
    lm = np.zeros((n_pad, d_pad, 3))
    uv = np.zeros((n_pad, d_pad, 2))
    cf = np.zeros((n_pad, d_pad))
    ov = np.zeros((n_pad, d_pad))
    lm[ii_w, slot] = lm_w
    uv[ii_w, slot] = uv_w
    cf[ii_w, slot] = conf_w
    ov[ii_w, slot] = 1.0

    kv = np.zeros(n_pad)
    kv[:n] = 1.0
    pv = np.zeros(n_pad)
    pv[: max(n - 1, 0)] = 1.0
    fields = dict(states=st, gaps=g, cum_rot=cr, lm_xyz=lm, uv=uv, conf=cf,
                  obs_valid=ov, pair_valid=pv, knot_valid=kv)
    fields = {k: v[None] for k, v in fields.items()}
    fields["intrinsics"] = np.asarray(intr_np)
    return sharded_ba.sharded_problem_from_numpy(fields, n_arc, device, dtype)


def stream_orbit_sharded(det_rows: np.ndarray, orbit_pos_eci_km: np.ndarray,
                         mesh: mesh_mod.Mesh, seed: int = 0,
                         cfg: StreamingConfig = StreamingConfig(),
                         solver: ba.SolverParams = ba.SolverParams(),
                         intrinsics: Optional[np.ndarray] = None,
                         shard_min_knots: int = -1) -> StreamingResult:
    """Streaming OD with each window solved over the mesh's arc shards when
    it is big enough to profit from it; on the mesh's device.

    Modes: growing-prefix (default) and bounded `marginalize=True`.
    shard_min_knots: windows below this bucketed knot count solve on one
    shard; -1 = SHARD_MIN_KNOTS_DEFAULT; 0 shards every window.
    """
    _check_supported(cfg)
    device, n_arc = mesh.device, mesh.n_arc
    if shard_min_knots < 0:
        shard_min_knots = SHARD_MIN_KNOTS_DEFAULT
    mesh_one = mesh_mod.make_mesh(1, 1, device=device)
    dtype = _DTYPES[cfg.dtype]

    def t(a, dt=dtype):
        return torch.tensor(np.asarray(a), dtype=dt, device=device)

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
    gaps, cum_rot, knot_t, intr_np = (prep.gaps, prep.cum_rot, prep.knot_t,
                                      prep.intr_np)

    windows = ingest.split_windows(graph.ii, knot_t)
    first_detection = int(knot_t[windows[0][0] - 1])

    max_hops = int(np.ceil(gaps.max() / solver.max_substep)) + 1
    solver = solver._replace(
        num_hops=max(solver.num_hops, max_hops),
        max_iters=solver.max_iters if solver.max_iters > 0
        else cfg.max_iters)
    # the reduced budget of multi-pass growing-prefix windows; bounded
    # windows keep the full one
    bounded = cfg.marginalize
    solver_later = solver
    if cfg.max_iters_later > 0 and solver.max_iters > 0 and not bounded:
        solver_later = solver._replace(
            max_iters=min(solver.max_iters, max(cfg.max_iters_later,
                                                cfg.num_iters + 1)))

    errors: List[np.ndarray] = []
    times: List[np.ndarray] = []
    cur_states: Optional[np.ndarray] = None
    marg_info: Optional[np.ndarray] = None
    t_prev = 0
    i_prev = 0

    def pad_sizes(Nw: int, i0: int, i1: int, k0: int):
        nb = bucket(Nw, cfg.knot_bucket)
        small = shard_min_knots > 0 and nb < shard_min_knots
        n_pad = nb if small else _round_up(nb, n_arc)
        counts = np.bincount(graph.ii[i0:i1] - k0, minlength=1)
        d_pad = _pow2(int(counts.max()) if len(counts) else 1)
        return n_pad, d_pad, small

    def propagate(last_state, t_init: int, t_stop: int) -> np.ndarray:
        span = int(knot_t[t_stop - 1] - knot_t[t_init - 1])
        om = gt.omega_full[knot_t[t_init - 1]:knot_t[t_stop - 1]]
        path = _propagate_impl(t(last_state), t(om), span).cpu().numpy()
        return path[knot_t[t_init:t_stop] - knot_t[t_init - 1]]

    def window_marginal(states_w, k0: int, i0: int, i1: int, t1: int,
                        extra_diag0) -> np.ndarray:
        """The terminal marginal of the window just solved (unsharded)."""
        n, m = states_w.shape[0], i1 - i0
        prob = ba.problem_from_numpy(dict(
            gaps=gaps[k0:t1], cum_rot=cum_rot[k0:t1],
            landmarks_xyz=gt.landmarks_xyz[i0:i1],
            landmarks_uv=graph.uv[i0:i1], conf=graph.conf[i0:i1],
            ii=graph.ii[i0:i1] - k0, obs_valid=np.ones(m),
            knot_valid=np.ones(n), pair_valid=np.ones(max(n - 1, 1)),
            intrinsics=intr_np), device, dtype)
        extra = np.zeros((n, 9, 9))
        if extra_diag0 is not None:
            extra[0] = extra_diag0
        return ba.terminal_marginal_info(
            t(states_w), prob, solver, extra_diag=t(extra)
        ).cpu().numpy().astype(np.float64)

    for w, (t_final, i_final, seq_end) in enumerate(windows):
        extra_diag0 = None
        k0 = 0
        if w == 0:
            window_states = states[:t_final]
        else:
            t_init = t_prev
            states_prop = propagate(cur_states[-1], t_init, t_final)
            errors.append(np.linalg.norm(
                states_prop[:, :3] - gt.states[t_init:t_final, :3],
                axis=-1)[:-1])
            times.append(knot_t[t_init:t_final][:-1])
            if bounded and marg_info is not None:
                k0 = t_prev - 1
                window_states = np.concatenate([cur_states[-1:], states_prop],
                                               axis=0)
            else:
                window_states = np.concatenate([cur_states, states_prop],
                                               axis=0)

        i0 = i_prev if (w > 0 and bounded and marg_info is not None) else 0
        Nw = t_final - k0
        n_pad, d_pad, small = pad_sizes(Nw, i0, i_final, k0)
        n_shards = 1 if small else n_arc

        def build(states_w):
            return _build_window_problem(
                states_w, gaps[k0:t_final], cum_rot[k0:t_final],
                gt.landmarks_xyz[i0:i_final], graph.uv[i0:i_final],
                graph.conf[i0:i_final], graph.ii[i0:i_final] - k0, n_pad,
                d_pad, intr_np, dtype, n_arc=n_shards, device=device)

        prob = build(window_states)
        init_iters = cfg.init_iters if w == 0 else 0
        if w == 0 and cfg.window0_init_f64:
            # window 0's init phase in f64 (a no-op on an f64 stream); the
            # sharded solve warm-starts from it
            m_pad = bucket(max(i_final, 1), cfg.obs_bucket, cfg.obs_bucket)
            st0, flat = _pad_problem(
                window_states, gaps[:t_final], cum_rot[:t_final],
                gt.landmarks_xyz[:i_final], graph.uv[:i_final],
                graph.conf[:i_final], graph.ii[:i_final], n_pad, m_pad,
                device, dtype, intrinsics=intr_np)
            o64 = _window0_init_f64(st0, flat, cfg.lambda_init, init_iters,
                                    solver)
            if o64 is not None:
                window_states = o64[:t_final].cpu().numpy()
                init_iters = 0
                prob = build(window_states)

        use_prior = bounded and w > 0 and marg_info is not None
        prior = None
        if use_prior:
            Hs0, Hr0, extra_diag0 = compose_prior_blocks(ba.inflate_info(
                marg_info, cfg.prior_pos_floor_km, cfg.prior_rot_floor,
                cfg.prior_vel_floor))
            ps = np.zeros((n_pad, 10))
            ps[:, 6] = 1.0
            ps[0] = cur_states[-1]
            Hs = np.zeros((n_pad, 6, 6))
            Hr = np.zeros((n_pad, 3, 3))
            val = np.zeros(n_pad)
            Hs[0], Hr[0], val[0] = Hs0, Hr0, 1.0
            Nl = n_pad // n_shards
            prior = sharded_ba.ShardedPrior(*(
                t(a).reshape((1, n_shards, Nl) + a.shape[1:])
                for a in (ps, Hs, Hr, val)))

        # the observability-gated reduced budget, as window.stream_orbit;
        # the gap bridge runs only the hops this window's gaps use (a
        # zero-length hop changes nothing)
        later = (not bounded and w > 0
                 and _multi_pass_window(knot_t[graph.ii[:i_final]], cfg))
        params = (solver_later if later else solver)
        params = params._replace(num_hops=min(params.num_hops,
                                              dynamics.active_hops(
                                                  gaps[k0:t_final],
                                                  params.max_substep)))
        solve = sharded_ba.make_sharded_window_solver(
            mesh_one if small else mesh, params, num_iters=cfg.num_iters,
            init_iters=init_iters, with_prior=use_prior)

        def run(lam0: float) -> np.ndarray:
            out, _, _ = solve(torch.full((1,), lam0, dtype=dtype,
                                         device=device), prob, prior)
            return out[0].reshape(-1, 10)[:Nw].cpu().numpy()

        out_np = run(cfg.lambda_init)
        if not np.isfinite(out_np).all():
            # failure recovery (window.stream_orbit's ladder): a heavily
            # damped re-run, then the warm start
            out_np = run(1e2)
            if not np.isfinite(out_np).all():
                out_np = window_states

        if bounded:
            marg_info = window_marginal(out_np, k0, i0, i_final, t_final,
                                        extra_diag0)
        cur_states = (np.concatenate([cur_states[:-1], out_np], axis=0)
                      if k0 > 0 else out_np)
        t_prev, i_prev = t_final, i_final

        errors.append(np.linalg.norm(
            cur_states[-1:, :3] - gt.states[t_final - 1:t_final, :3],
            axis=-1))
        times.append(knot_t[t_final - 1:t_final])

        if seq_end and t_final < len(knot_t):
            if cfg.tail_refine:
                # the terminal refinement before the open-loop tail, as in
                # window.stream_orbit (unsharded: O(arc) work)
                cur_states = refine.refine_terminal(
                    cur_states, gaps[:t_final], gt.landmarks_xyz, graph.uv,
                    graph.conf, graph.ii, intr_np, dtype,
                    max_substep=solver.max_substep,
                    cum_rot=(cum_rot[:t_final] if cfg.tail_refine_rigid
                             else None),
                    att_sigma=cfg.tail_refine_att_sigma,
                    ratio=cfg.tail_refine_ratio, device=device)
            states_prop = propagate(cur_states[-1], t_final, len(knot_t))
            errors.append(np.linalg.norm(
                states_prop[:, :3] - gt.states[t_final:, :3], axis=-1))
            times.append(knot_t[t_final:])

    return StreamingResult(
        errors=np.concatenate(errors) if errors else np.array([]),
        times=np.concatenate(times) if times else np.array([]),
        first_detection=first_detection,
        final_states=cur_states,
        knot_times=knot_t[:t_prev],
    )
