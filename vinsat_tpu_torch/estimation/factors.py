"""Factor-graph residuals and analytic Jacobians (port of the streaming
slice's part of vinsat_tpu/estimation/factors.py).

State per knot: [pos(3) km ECI, quat(4) scalar-last, vel(3) km/s];
tangent: [dpos(3), dphi(3), dvel(3)].  Every Jacobian is analytic in the
reference's Gq-lift convention (no 1/2 factor), exactly as in the JAX
package.

`project_landmarks`, `reprojection_factor` and `dynamics_factor` broadcast
over leading batch dimensions of `states` (the port's batched λ search
evaluates K candidate state sets at once, the constellation solve B orbits,
and the arc-sharded step every orbit and shard, where the JAX package vmaps
and shard_maps).  With an orbit axis each orbit's observations index its
own knots: `ii` (B, M) against `states` (..., B, N, 10)
(`gather_knots`).
`lax.associative_scan` becomes `_inclusive_scan`, a log-depth
Hillis–Steele scan.  The window handoff's prior factor (`prior_factor`)
and IMU rotations over spans (`span_rotations`) serve the prior and
bounded-window stream modes.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from vinsat_tpu_torch.core import dynamics, quat


def _inclusive_scan(x, combine: Callable):
    """Log-depth Hillis–Steele inclusive scan along dim 0:
    out[i] = x[0] ∘ x[1] ∘ ... ∘ x[i], with combine(earlier, later) for an
    associative (not necessarily commutative) ∘."""
    n = x.shape[0]
    d = 1
    while d < n:
        x = torch.cat([x[:d], combine(x[:-d], x[d:])], dim=0)
        d *= 2
    return x


def right_mult_matrix(q2):
    """M(q2) with q1 ⊗ q2 = M(q2) @ q1, scalar-last."""
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            torch.stack([w2, z2, -y2, x2], dim=-1),
            torch.stack([-z2, w2, x2, y2], dim=-1),
            torch.stack([y2, -x2, w2, z2], dim=-1),
            torch.stack([-x2, -y2, -z2, w2], dim=-1),
        ],
        dim=-2,
    )


def _dGqT_g(g):
    """A(g) = d(Gq(q)^T g)/dq, a (..., 3, 4) matrix linear in g."""
    gx, gy, gz, gw = g.unbind(-1)
    return torch.stack(
        [
            torch.stack([-gw, -gz, gy, gx], dim=-1),
            torch.stack([gz, -gw, -gx, gy], dim=-1),
            torch.stack([-gy, gx, -gw, gz], dim=-1),
        ],
        dim=-2,
    )


# ---------------------------------------------------------------------------
# Reprojection factor
# ---------------------------------------------------------------------------


class ReprojFactor(NamedTuple):
    uv: torch.Tensor  # (..., M, 2) predicted pixels
    J: torch.Tensor  # (..., M, 2, 9) tangent Jacobian (vel columns zero)


def gather_knots(states, ii):
    """The knot row of each observation: states[..., ii, :] for ii (M,);
    for ii (B, M) against states (..., B, N, C) each orbit gathers its own
    knots -> (..., B, M, C)."""
    if ii.dim() == 1:
        return states[..., ii, :]
    idx = ii[..., None].expand(*states.shape[:-2], ii.shape[-1],
                               states.shape[-1])
    return torch.gather(states, -2, idx)


def project_landmarks(states, landmarks_xyz, ii, intrinsics):
    """Predicted pixel coords of each observation.  states (..., N, 10);
    landmarks_xyz (M, 3); ii (M,) int64 obs->knot; intrinsics (4,) =
    (fx, fy, cx, cy) as a tensor.  With an orbit axis: states (..., B, N,
    10), landmarks_xyz (B, M, 3), ii (B, M)."""
    st = gather_knots(states, ii)
    p_cam = quat.rotate_inverse(st[..., 3:7], landmarks_xyz - st[..., :3])
    fx, fy, cx, cy = intrinsics.unbind(-1)
    d = 1.0 / torch.clamp(p_cam[..., 2], min=0.1)
    u = fx * p_cam[..., 0] * d + cx
    v = fy * p_cam[..., 1] * d + cy
    return torch.stack([u, v], dim=-1)


def _skew(p):
    px, py, pz = p.unbind(-1)
    z0 = torch.zeros_like(px)
    return torch.stack(
        [
            torch.stack([z0, -pz, py], dim=-1),
            torch.stack([pz, z0, -px], dim=-1),
            torch.stack([-py, px, z0], dim=-1),
        ],
        dim=-2,
    )


def reprojection_factor(states, landmarks_xyz, ii, intrinsics) -> ReprojFactor:
    """Pixel prediction + analytic (M, 2, 9) Jacobian in the Gq-lift
    convention (d p_cam / d phi = 2 [p_cam]_x).  Shapes as in
    project_landmarks."""
    st = gather_knots(states, ii)
    pos = st[..., :3]
    q = st[..., 3:7]
    p_cam = quat.rotate_inverse(q, landmarks_xyz - pos)
    fx, fy, cx, cy = intrinsics.unbind(-1)
    X, Y, Z = p_cam.unbind(-1)
    d = 1.0 / torch.clamp(Z, min=0.1)
    uv = torch.stack([fx * X * d + cx, fy * Y * d + cy], dim=-1)

    # d uv / d p_cam, with the clamp's dead zone (d'(Z)=0 for Z<0.1)
    dd_dZ = torch.where(Z > 0.1, -d * d, torch.zeros_like(d))
    zeros = torch.zeros_like(X)
    duv_dp = torch.stack(
        [
            torch.stack([fx * d, zeros, fx * X * dd_dZ], dim=-1),
            torch.stack([zeros, fy * d, fy * Y * dd_dZ], dim=-1),
        ],
        dim=-2,
    )  # (M, 2, 3)

    dp_dpos = -quat.to_matrix(q).transpose(-1, -2)
    dp_dphi = 2.0 * _skew(p_cam)
    J_pos = duv_dp @ dp_dpos
    J_phi = duv_dp @ dp_dphi
    J = torch.cat([J_pos, J_phi, torch.zeros_like(J_pos)], dim=-1)
    return ReprojFactor(uv=uv, J=J)


# ---------------------------------------------------------------------------
# Dynamics factor
# ---------------------------------------------------------------------------


class DynamicsFactor(NamedTuple):
    """res_pv (N-1, 6), res_q (N-1,), A / B (N-1, 6, 9), qgrad (N, 9),
    Hq_diag (N, 9, 9), Hq_off (N-1, 9, 9), state_pred (N, 10) — the fields
    of the JAX DynamicsFactor, after the inputs' leading batch dims."""

    res_pv: torch.Tensor
    res_q: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor
    qgrad: torch.Tensor
    Hq_diag: torch.Tensor
    Hq_off: torch.Tensor
    state_pred: torch.Tensor


def _quat_residual_terms(q, cum_rot, quat_coeff, valid_pair):
    """Exact gradient + block-tridiagonal Hessian of
        sum_t quat_coeff * (1 - |<q_t ⊗ c_t, q_{t+1}>|)
    in the Gq-lift convention (derivation in the JAX module).  q, cum_rot
    (..., N, 4) and valid_pair (..., N-1) broadcast over leading dims."""
    N = q.shape[-2]
    res_q, q_hat, d = _quat_residual(q, cum_rot, quat_coeff, valid_pair)
    s = torch.sign(d) * valid_pair
    k = quat_coeff
    batch = s.shape[:-1]
    opts = dict(dtype=q.dtype, device=q.device)

    M = right_mult_matrix(cum_rot[..., :-1, :])  # (..., N-1, 4, 4)
    g_t = -k * s[..., None] * torch.einsum("...tji,...tj->...ti", M,
                                           q[..., 1:, :])
    g_t1 = -k * s[..., None] * q_hat

    g_amb = torch.zeros(batch + (N, 4), **opts)
    g_amb[..., :-1, :] += g_t
    g_amb[..., 1:, :] += g_t1

    Gq = quat.attitude_jacobian(q)  # (..., N, 4, 3)
    qgrad3 = torch.einsum("...nij,...ni->...nj", Gq, g_amb)
    qgrad = torch.zeros(batch + (N, 9), **opts)
    qgrad[..., 3:6] = qgrad3

    Hdiag3 = _dGqT_g(g_amb) @ Gq
    cross = -k * s[..., None, None] * M.transpose(-1, -2)  # (..., N-1, 4, 4)
    Hoff3 = Gq[..., :-1, :, :].transpose(-1, -2) @ cross @ Gq[..., 1:, :, :]

    Hq_diag = torch.zeros(batch + (N, 9, 9), **opts)
    Hq_diag[..., 3:6, 3:6] = Hdiag3
    Hq_off = torch.zeros(batch + (N - 1, 9, 9), **opts)
    Hq_off[..., 3:6, 3:6] = Hoff3
    return res_q, qgrad, Hq_diag, Hq_off, q_hat


def _quat_residual(q, cum_rot, quat_coeff, valid_pair):
    """res_q, q_hat = q_t ⊗ c_t and d = <q_hat_t, q_{t+1}>, batched over
    leading dims of q (..., N, 4) (and of cum_rot, valid_pair)."""
    q_hat = quat.multiply(q[..., :-1, :], cum_rot[..., :-1, :])
    d = (q_hat * q[..., 1:, :]).sum(-1)
    return quat_coeff * (1.0 - d.abs()) * valid_pair, q_hat, d


def dynamics_factor(states, gaps, cum_rot, quat_coeff, vel_coeff,
                    valid_pair=None, num_hops: int = 16,
                    max_substep: float = 100.0,
                    with_jacobian: bool = True) -> DynamicsFactor:
    """Dynamics factor over consecutive knots.  states (..., N, 10); gaps
    (..., N) seconds to the next knot; cum_rot (..., N, 4); valid_pair
    (..., N-1) 0/1 mask — leading dims broadcast against each other."""
    N = states.shape[-2]
    dtype, dev = states.dtype, states.device
    pos, q, vel = states[..., :3], states[..., 3:7], states[..., 7:10]
    if valid_pair is None:
        valid_pair = torch.ones(N - 1, dtype=dtype, device=dev)

    if with_jacobian:
        p_pred, v_pred, Jfull = dynamics.propagate_gaps_with_jacobian(
            pos, vel, gaps, num_hops=num_hops, max_substep=max_substep)
    else:
        p_pred, v_pred = dynamics.propagate_gaps(
            pos, vel, gaps, num_hops=num_hops, max_substep=max_substep)

    vp = valid_pair[..., None]
    res_pv = torch.cat(
        [
            (p_pred[..., :-1, :] - pos[..., 1:, :]) * vp,
            vel_coeff * (v_pred[..., :-1, :] - vel[..., 1:, :]) * vp,
        ],
        dim=-1,
    )

    if not with_jacobian:
        res_q, q_hat, _ = _quat_residual(q, cum_rot, quat_coeff, valid_pair)
        q_pred = torch.cat([q_hat, q[..., -1:, :]], dim=-2)
        state_pred = torch.cat([p_pred, q_pred, v_pred], dim=-1)
        return DynamicsFactor(res_pv, res_q, None, None, None, None, None,
                              state_pred)

    res_q, qgrad, Hq_diag, Hq_off, q_hat = _quat_residual_terms(
        q, cum_rot, quat_coeff, valid_pair)
    q_pred = torch.cat([q_hat, q[..., -1:, :]], dim=-2)
    state_pred = torch.cat([p_pred, q_pred, v_pred], dim=-1)

    # res_pv[t] wrt knot t: weighted transition Jacobian; wrt knot t+1: -W
    Jt = Jfull[..., :-1, :, :]  # (..., N-1, 6, 6)
    W = torch.ones(6, dtype=dtype, device=dev)
    W[3:] = vel_coeff
    A6 = W[None, :, None] * Jt * vp[..., None]
    A = torch.zeros(A6.shape[:-1] + (9,), dtype=dtype, device=dev)
    A[..., 0:3] = A6[..., 0:3]
    A[..., 6:9] = A6[..., 3:6]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    B = torch.zeros(A6.shape[:-2] + (6, 9), dtype=dtype, device=dev)
    B[..., 0:3, 0:3] = -eye3 * vp[..., None]
    B[..., 3:6, 6:9] = -vel_coeff * eye3 * vp[..., None]
    return DynamicsFactor(res_pv, res_q, A, B, qgrad, Hq_diag, Hq_off,
                          state_pred)


def cumulative_rotations(omega_seq, dt, knot_times):
    """Per-knot cumulative IMU rotation over each inter-knot gap: (N, 4)
    with c_t = prod_{k=t_i}^{t_{i+1}-1} exp(dt w_k), last entry identity.
    Prefix products P(a, b) = R_a^* ⊗ R_b from one log-depth scan.
    omega_seq (..., T, 3) and knot_times (..., N) may carry an orbit axis
    (B orbits of one arc length, each with its own knots)."""
    rots = quat.exp(dt * omega_seq)  # (..., T, 4)
    ident = torch.zeros_like(rots[..., :1, :])
    ident[..., 0, 3] = 1.0
    prefix = _inclusive_scan(
        torch.cat([ident, rots], dim=-2).movedim(-2, 0),
        quat.multiply).movedim(0, -2)
    nxt = torch.cat([knot_times[..., 1:], knot_times[..., -1:]], dim=-1)
    Ra = gather_knots(prefix, knot_times)
    Rb = gather_knots(prefix, nxt)
    return quat.normalize(quat.multiply(quat.conjugate(Ra), Rb))


def span_rotations(omega_seq, dt, start: int, ends):
    """IMU rotation products over [start, e) for each e in `ends`:
    c_e = prod_{k=start}^{e-1} exp(dt w_k), from the same prefix scan as
    cumulative_rotations.  omega_seq (T, 3); start a host int; ends (N,)
    int64 -> (N, 4)."""
    rots = quat.exp(dt * omega_seq)
    ident = torch.zeros_like(rots[:1])
    ident[0, 3] = 1.0
    prefix = _inclusive_scan(torch.cat([ident, rots], dim=0), quat.multiply)
    Ra = prefix[int(start)]
    Rb = prefix[ends]
    return quat.normalize(quat.multiply(quat.conjugate(Ra)[None], Rb))


# ---------------------------------------------------------------------------
# Prior factor (the window handoff)
# ---------------------------------------------------------------------------


class PriorFactor(NamedTuple):
    res: torch.Tensor  # (N, 7) [state residual(6), rot residual(1)]
    Jp: torch.Tensor  # (N, 6, 9) jacobian of the 6-dim state residual
    qgrad: torch.Tensor  # (N, 9)
    Hq_diag: torch.Tensor  # (N, 9, 9)


def prior_factor(states, prop_states, H_state, H_rot, vel_coeff_prior,
                 quat_coeff_prior, valid=None) -> PriorFactor:
    """Marginal prior tying knots to the states propagated from the
    previous window:
    res_state_i = H_state_i @ [pos_prop - pos; vc*(vel_prop - vel)] (6),
    res_rot_i   = qc * (1 - |q_prop^T Gq_prop H_rot Gq(q)^T q|).
    H_state (N, 6, 6), H_rot (N, 3, 3) are propagated information
    matrices; the rotation term's gradient and lifted curvature are the
    JAX package's closed forms (its module says why they look as they
    do).  states (..., N, 10) may lead with λ candidates."""
    N, dtype, dev = states.shape[-2], states.dtype, states.device
    lead = states.shape[:-1]
    if valid is None:
        valid = torch.ones(N, dtype=dtype, device=dev)
    pos, q, vel = states[..., :3], states[..., 3:7], states[..., 7:10]
    pos_p, q_p, vel_p = (prop_states[:, :3], prop_states[:, 3:7],
                         prop_states[:, 7:10])

    dr = torch.cat([pos_p - pos, vel_coeff_prior * (vel_p - vel)], -1)
    res_state = (H_state @ dr[..., None])[..., 0] * valid[:, None]

    W = torch.cat([torch.ones(3, dtype=dtype, device=dev),
                   vel_coeff_prior * torch.ones(3, dtype=dtype, device=dev)])
    J6 = -(H_state * W[None, None, :]) * valid[:, None, None]
    Jp = torch.zeros((N, 6, 9), dtype=dtype, device=dev)
    Jp[:, :, 0:3] = J6[:, :, 0:3]
    Jp[:, :, 6:9] = J6[:, :, 3:6]
    Jp = Jp.expand(lead + (6, 9))

    Gq = quat.attitude_jacobian(q)
    Gq_p = quat.attitude_jacobian(q_p)
    b = (Gq_p.transpose(-1, -2) @ q_p[..., None])[..., 0]  # (N, 3)
    Hb = (H_rot.transpose(-1, -2) @ b[..., None])[..., 0]  # H_rot^T b
    m = (Gq.transpose(-1, -2) @ q[..., None])[..., 0]
    scal = (m * Hb).sum(-1)
    s = torch.where(scal == 0, torch.ones_like(scal), torch.sign(scal))
    res_rot = quat_coeff_prior * (1.0 - scal.abs()) * valid

    dm_dq = _dGqT_g(q) + Gq.transpose(-1, -2)  # (..., N, 3, 4)
    g_amb = (-quat_coeff_prior * s[..., None]
             * (Hb[..., None, :] @ dm_dq)[..., 0, :] * valid[:, None])
    qgrad = torch.zeros(lead + (9,), dtype=dtype, device=dev)
    qgrad[..., 3:6] = (Gq.transpose(-1, -2) @ g_amb[..., None])[..., 0]
    Hq_diag = torch.zeros(lead + (9, 9), dtype=dtype, device=dev)
    Hq_diag[..., 3:6, 3:6] = _dGqT_g(g_amb) @ Gq

    res = torch.cat([res_state, res_rot[..., None]], dim=-1)
    return PriorFactor(res=res, Jp=Jp, qgrad=qgrad, Hq_diag=Hq_diag)
