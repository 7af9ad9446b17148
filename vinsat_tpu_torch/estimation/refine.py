"""Shooting-based terminal refinement (port of
vinsat_tpu/estimation/refine.py).

After the last detection pass the stream propagates the terminal knot
open-loop to the arc end; these fits re-estimate ONE initial condition
through the full RK4 dynamics against all gated observations before that
propagation: the 6-dof [pos, vel] fit with fixed attitudes
(`shooting_refine`) and the 9-dof rigid-attitude-chain fit
(`shooting_refine_rigid`), combined by `refine_states_device_full`'s
selection policy.  Fixed iteration counts and device-side selects, as in
the JAX package.

The rollout differs in form, not in value: the knot chain's active hops
are known on the host (`dynamics.hop_schedule`), so the state chain runs
hop by hop and skips zero-length hops, and the sensitivities
Phi_k = d x_k / d x_0 come afterwards from the batched hop Jacobians and
one log-depth scan of 6x6 products.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from vinsat_tpu_torch.config import (DEFAULT_DEVICE, resolve_device,
                                     to_device)
from vinsat_tpu_torch.core import dynamics, quat
from vinsat_tpu_torch.estimation import factors


class ShootingResult(NamedTuple):
    states_pv: torch.Tensor  # (N, 6) refined [pos, vel] at every knot
    residual: torch.Tensor  # final mean |r| (px)
    residual0: torch.Tensor  # initial mean |r| (px) at the warm start


class RigidShootingResult(NamedTuple):
    states: torch.Tensor  # (N, 10) refined [pos, quat, vel] at every knot
    residual: torch.Tensor  # final mean |r| (px) of the rigid fit
    residual_in: torch.Tensor  # mean |r| of the INPUT states


class _HopPlan(NamedTuple):
    hops: List[float]  # every active hop of the knot chain, in order
    h: torch.Tensor  # (H, 1) the same on the device
    knot_idx: torch.Tensor  # (N,) hops completed at each knot (0 at knot 0)


def _hop_plan(gaps, num_hops: int, max_substep: float, device,
              dtype) -> _HopPlan:
    """Host schedule of the chain's active hops over knot gaps (N-1,).
    Host gaps (numpy) keep the plan free of host waits; a gaps tensor is
    read back first."""
    if isinstance(gaps, torch.Tensor):
        gaps = gaps.detach().cpu().numpy()
    gaps = np.asarray(gaps, np.float64)
    hops: List[float] = []
    counts = [0]
    for g in gaps:
        hops += dynamics.hop_schedule(float(g), num_hops, max_substep)
        counts.append(len(hops))
    return _HopPlan(
        hops,
        to_device(np.asarray(hops, np.float64), dtype, device).reshape(-1, 1),
        to_device(np.asarray(counts, np.int64), torch.int64, device))


def _rollout(x0, plan: _HopPlan):
    xs_h = dynamics.rk4_chain(x0, plan.hops)  # (H+1, 6)
    eye6 = torch.eye(6, dtype=x0.dtype, device=x0.device)
    _, A = dynamics.rk4_step_with_jacobian(xs_h[:-1], plan.h)  # (H, 6, 6)
    P = factors._inclusive_scan(A, lambda a, b: b @ a)  # A_h ... A_0
    P = torch.cat([eye6[None], P], dim=0)
    return xs_h[plan.knot_idx], P[plan.knot_idx]


def _rollout_with_sensitivity(x0, gaps, num_hops: int, max_substep: float):
    """Roll [pos, vel] down the knot chain (gaps (N-1,)) and return the
    states (N, 6) and cumulative sensitivities Phi_k = d x_k / d x_0."""
    return _rollout(x0, _hop_plan(gaps, num_hops, max_substep, x0.device,
                                  x0.dtype))


def _solve(H, g):
    """Small dense solve without a host sync (no error check)."""
    return torch.linalg.solve_ex(H, g[:, None])[0][:, 0]


def _mean_abs(r, w):
    return (r.abs() * w[:, None]).sum() / torch.clamp(2.0 * w.sum(), min=1.0)


def shooting_refine(states, gaps, lm_xyz, uv, conf, ii, obs_valid,
                    intrinsics, num_hops: int = 16,
                    max_substep: float = 100.0, num_iters: int = 20):
    """Gauss-Newton shooting fit of the 6-dof initial [pos, vel], per-knot
    attitudes held fixed.  Returns the refined per-knot [pos, vel] and the
    residual diagnostics."""
    dtype, dev = states.dtype, states.device
    plan = _hop_plan(gaps[:-1], num_hops, max_substep, dev, dtype)
    q_fix = states[:, 3:7]
    x0_init = torch.cat([states[0, :3], states[0, 7:10]])
    w = conf * obs_valid
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def residuals(x0):
        xs, Phis = _rollout(x0, plan)
        st10 = torch.cat([xs[:, :3], q_fix, xs[:, 3:]], dim=-1)
        rp = factors.reprojection_factor(st10, lm_xyz, ii, intrinsics)
        r = (uv - rp.uv) * obs_valid[:, None]
        Jm = rp.J[:, :, 0:3] @ Phis[ii][:, 0:3, :]  # (M, 2, 6)
        return r, Jm, xs

    r0, _, _ = residuals(x0_init)
    res0 = _mean_abs(r0, w)
    x0, lam = x0_init, torch.full((), 1e-8, dtype=dtype, device=dev)
    best_x0, best_res = x0_init, res0
    for _ in range(num_iters):
        r, Jm, _ = residuals(x0)
        res = _mean_abs(r, w)
        take = res < best_res
        best_x0 = torch.where(take, x0, best_x0)
        best_res = torch.where(take, res, best_res)
        JW = Jm * w[:, None, None]
        H = JW.reshape(-1, 6).T @ Jm.reshape(-1, 6)
        g = JW.reshape(-1, 6).T @ r.reshape(-1)
        # Jacobi-scaled damped solve (pos ~1e3 km vs vel ~1 km/s scales)
        s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-30))
        Hs = H * s[:, None] * s[None, :] + lam * eye6
        x0_new = x0 + s * _solve(Hs, s * g)
        r1, _, _ = residuals(x0_new)
        accept = _mean_abs(r1, w) < res
        x0 = torch.where(accept, x0_new, x0)
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-12),
                          lam * 10.0)
    r_last, _, _ = residuals(x0)
    res_last = _mean_abs(r_last, w)
    x0_out = torch.where(res_last <= best_res, x0, best_x0)
    _, _, xs = residuals(x0_out)
    return ShootingResult(states_pv=xs,
                          residual=torch.minimum(res_last, best_res),
                          residual0=res0)


def shooting_refine_rigid(states, gaps, cum_rot, lm_xyz, uv, conf, ii,
                          obs_valid, intrinsics, num_hops: int = 16,
                          max_substep: float = 100.0, num_iters: int = 24,
                          att_sigma: float = 1e-2):
    """9-dof shooting fit on the RIGID attitude chain: x0 = [pos, vel] plus
    one initial-attitude correction delta transported through the known
    rate chain, q_i(delta) = (q_0 ⊞ delta) ⊗ C_i.  delta carries a weak
    prior (att_sigma, rad).  Returns the refined full states, the fit
    residual and the INPUT states' residual (acceptance is a ratio test)."""
    dtype, dev = states.dtype, states.device
    N = states.shape[0]
    plan = _hop_plan(gaps[:-1], num_hops, max_substep, dev, dtype)
    x0_init = torch.cat([states[0, :3], states[0, 7:10]])
    w = conf * obs_valid
    inv_s2 = 1.0 / (float(att_sigma) ** 2)
    eye9 = torch.eye(9, dtype=dtype, device=dev)

    # prefix chain C_i: C_0 = I, C_{i+1} = C_i ⊗ c_i
    ident = torch.zeros((1, 4), dtype=dtype, device=dev)
    ident[0, 3] = 1.0
    C = factors._inclusive_scan(torch.cat([ident, cum_rot[:-1]], dim=0),
                                quat.multiply)
    Rt = quat.to_matrix(C).transpose(-1, -2)  # R(C_i)^T (N, 3, 3)
    q_chain = quat.normalize(quat.multiply(states[0, 3:7].expand(N, 4), C))
    Rt_ii = Rt[ii]

    def residuals(th):
        xs, Phis = _rollout(th[:6], plan)
        eps = (Rt @ th[6:, None])[..., 0]
        q = quat.box_plus(q_chain, eps)
        st10 = torch.cat([xs[:, :3], q, xs[:, 3:]], dim=-1)
        rp = factors.reprojection_factor(st10, lm_xyz, ii, intrinsics)
        r = (uv - rp.uv) * obs_valid[:, None]
        Jx = rp.J[:, :, 0:3] @ Phis[ii][:, 0:3, :]
        Jd = rp.J[:, :, 3:6] @ Rt_ii
        return r, torch.cat([Jx, Jd], dim=-1), st10

    def obj(r, delta):
        return (0.5 * ((r ** 2) * w[:, None]).sum()
                + 0.5 * inv_s2 * (delta ** 2).sum())

    # guard baseline: the INPUT states' residual (streaming attitudes)
    rp_in = factors.reprojection_factor(states, lm_xyz, ii, intrinsics)
    res_in = _mean_abs((uv - rp_in.uv) * obs_valid[:, None], w)

    th = torch.cat([x0_init, torch.zeros(3, dtype=dtype, device=dev)])
    r0, _, _ = residuals(th)
    lam = torch.full((), 1e-8, dtype=dtype, device=dev)
    bth, bobj = th, obj(r0, th[6:])
    for _ in range(num_iters):
        r, J, _ = residuals(th)
        f = obj(r, th[6:])
        take = f < bobj
        bth = torch.where(take, th, bth)
        bobj = torch.where(take, f, bobj)
        JW = J * w[:, None, None]
        H = JW.reshape(-1, 9).T @ J.reshape(-1, 9)
        H[6:, 6:] += inv_s2 * eye9[:3, :3]
        g = JW.reshape(-1, 9).T @ r.reshape(-1)
        g[6:] += -inv_s2 * th[6:]
        s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-30))
        Hs = H * s[:, None] * s[None, :] + lam * eye9
        thn = th + s * _solve(Hs, s * g)
        r1, _, _ = residuals(thn)
        acc = obj(r1, thn[6:]) < f
        th = torch.where(acc, thn, th)
        lam = torch.where(acc, torch.clamp(lam * 0.3, min=1e-12), lam * 10.0)
    r_l, _, _ = residuals(th)
    th = torch.where(obj(r_l, th[6:]) <= bobj, th, bth)
    r, _, st10 = residuals(th)
    return RigidShootingResult(states=st10, residual=_mean_abs(r, w),
                               residual_in=res_in)


def refine_states_device(states, gaps, lm_xyz, uv, conf, ii, obs_valid,
                         intrinsics, num_hops: int = 16,
                         max_substep: float = 100.0, num_iters: int = 20):
    """6-dof refinement with the fallback as a device select: pos/vel are
    shooting-refined iff the fit is finite and improves the residual."""
    out = shooting_refine(states, gaps, lm_xyz, uv, conf, ii, obs_valid,
                          intrinsics, num_hops=num_hops,
                          max_substep=max_substep, num_iters=num_iters)
    ok = torch.isfinite(out.states_pv).all() & (out.residual
                                                 <= out.residual0)
    pv0 = torch.cat([states[:, :3], states[:, 7:10]], dim=-1)
    pv = torch.where(ok, out.states_pv, pv0)
    return torch.cat([pv[:, :3], states[:, 3:7], pv[:, 3:]], dim=-1)


def refine_states_device_full(states, gaps, cum_rot, lm_xyz, uv, conf, ii,
                              obs_valid, intrinsics, num_hops: int = 16,
                              max_substep: float = 100.0,
                              num_iters: int = 20,
                              num_iters_rigid: int = 24,
                              att_sigma: float = 1e-2, ratio: float = 1.3):
    """Tail refinement with both fits and the selection policy: the rigid
    fit when finite and residual <= ratio * input residual, else the 6-dof
    fit when finite and improving, else the input states."""
    out9 = shooting_refine_rigid(
        states, gaps, cum_rot, lm_xyz, uv, conf, ii, obs_valid, intrinsics,
        num_hops=num_hops, max_substep=max_substep,
        num_iters=num_iters_rigid, att_sigma=att_sigma)
    st6 = refine_states_device(states, gaps, lm_xyz, uv, conf, ii, obs_valid,
                               intrinsics, num_hops=num_hops,
                               max_substep=max_substep, num_iters=num_iters)
    ok9 = torch.isfinite(out9.states).all() & (
        out9.residual <= ratio * torch.clamp(out9.residual_in, min=1e-6))
    return torch.where(ok9, out9.states, st6)


def refine_terminal(final_states: np.ndarray, gaps: np.ndarray,
                    lm_xyz: np.ndarray, uv: np.ndarray, conf: np.ndarray,
                    ii: np.ndarray, intrinsics: np.ndarray,
                    dtype=torch.float64, max_substep: float = 100.0,
                    num_iters: int = 20,
                    cum_rot: Optional[np.ndarray] = None,
                    att_sigma: float = 1e-2, ratio: float = 1.3,
                    device=DEFAULT_DEVICE) -> np.ndarray:
    """Host wrapper: refine the streaming solution over its knot span and
    return (N, 10) host states — the 6-dof fit with the original attitudes
    (cum_rot None) or the rigid-chain selection policy (cum_rot given).
    The JAX package pads to buckets to reuse compiled programs; eager torch
    needs no padding (padding there is exact, so results agree)."""
    device = resolve_device(device)
    states = torch.tensor(np.asarray(final_states), dtype=dtype,
                          device=device)
    return refine_terminal_device(
        states, gaps, lm_xyz, uv, conf, ii, intrinsics,
        max_substep=max_substep, num_iters=num_iters, cum_rot=cum_rot,
        att_sigma=att_sigma, ratio=ratio).cpu().numpy()


def refine_terminal_device(states, gaps: np.ndarray, lm_xyz: np.ndarray,
                           uv: np.ndarray, conf: np.ndarray, ii: np.ndarray,
                           intrinsics: np.ndarray, max_substep: float = 100.0,
                           num_iters: int = 20,
                           cum_rot: Optional[np.ndarray] = None,
                           att_sigma: float = 1e-2,
                           ratio: float = 1.3) -> torch.Tensor:
    """`refine_terminal` of states (N, 10) already on their device, in
    their dtype, returning the refined states there: the observations and
    gaps come from the host and the hop plan is made there, so nothing
    waits for the device (the stream's fast path chains it after the last
    window's solve)."""
    dtype, device = states.dtype, states.device
    N = states.shape[0]

    def t(a, dt=dtype):
        return to_device(np.asarray(a), dt, device)

    g = np.array(gaps, np.float64)
    g[N - 1:] = 0.0
    hops = int(np.ceil(max(g.max(), 1.0) / max_substep)) + 1
    args = (t(lm_xyz), t(uv), t(conf), t(ii, torch.int64),
            torch.ones(len(ii), dtype=dtype, device=device), t(intrinsics))
    if cum_rot is not None:
        return refine_states_device_full(
            states, g, t(cum_rot), *args, num_hops=hops,
            max_substep=max_substep, num_iters=num_iters,
            att_sigma=att_sigma, ratio=ratio)
    return refine_states_device(states, g, *args, num_hops=hops,
                                max_substep=max_substep,
                                num_iters=num_iters)
