"""EKF orbit determination over the knot sequence (port of
vinsat_tpu/estimation/ekf.py; BASELINE config 1, "EKF-only OD").

RK4 prediction with forward-sensitivity covariance propagation, then
per-knot pixel-measurement updates with the analytic reprojection
Jacobian; `run_smoother` adds the Rauch–Tung–Striebel backward pass.

The JAX package runs the filter as one `lax.scan`; here it is a host loop
over knots of eager tensor ops, as the port's other scans are.  No step
syncs with the host: the gaps are read once, so that each knot's
prediction runs only the hops its own gap uses (a zero-length hop changes
nothing), and the inverses are the non-raising `inv_ex` (a singular
matrix gives inf / NaN, as in the JAX package).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from vinsat_tpu_torch.core import dynamics, quat
from vinsat_tpu_torch.estimation import factors


class EKFState(NamedTuple):
    state: torch.Tensor  # (10,) [pos, quat, vel]
    cov: torch.Tensor  # (9, 9) tangent covariance


class EKFConfig(NamedTuple):
    meas_noise_px: float = 5.0
    process_noise_pos: float = 1e-6  # km^2 per propagation
    process_noise_phi: float = 1e-8
    process_noise_vel: float = 1e-8
    num_hops: int = 16
    max_substep: float = 100.0
    max_obs_per_knot: int = 16


def _inv(a):
    return torch.linalg.inv_ex(a)[0]


def _hops(gap: float, cfg: EKFConfig) -> int:
    """The hops of one host gap that carry a non-zero step."""
    return min(cfg.num_hops, dynamics.active_hops([gap], cfg.max_substep))


def _transition(state, gap, cum_rot, cfg: EKFConfig, num_hops: int):
    """(propagated pos, vel, the 9x9 tangent transition Jacobian F)."""
    p1, v1, J = dynamics.propagate_gaps_with_jacobian(
        state[None, :3], state[None, 7:10], gap[None], num_hops=num_hops,
        max_substep=cfg.max_substep)
    J6 = J[0]
    F = torch.zeros((9, 9), dtype=state.dtype, device=state.device)
    F[0:3, 0:3] = J6[0:3, 0:3]
    F[0:3, 6:9] = J6[0:3, 3:6]
    F[6:9, 0:3] = J6[3:6, 0:3]
    F[6:9, 6:9] = J6[3:6, 3:6]
    # rotation covariance transported by R(cum_rot)^T
    F[3:6, 3:6] = quat.to_matrix(cum_rot).transpose(-1, -2)
    return p1[0], v1[0], F


def predict(ekf: EKFState, gap, cum_rot, cfg: EKFConfig = EKFConfig(),
            num_hops=None) -> EKFState:
    """Propagate state and covariance across one inter-knot gap (a 0-d
    tensor): the pos/vel block by the hop scan's 6x6 transition Jacobian,
    the rotation block by R(cum_rot)ᵀ.  num_hops (default cfg.num_hops)
    may be cut to the gap's active hops."""
    s = ekf.state
    p1, v1, F = _transition(s, gap, cum_rot, cfg,
                            cfg.num_hops if num_hops is None else num_hops)
    q1 = quat.normalize(quat.multiply(s[3:7], cum_rot))
    Q = torch.diag(torch.cat([
        torch.full((3,), cfg.process_noise_pos, dtype=s.dtype,
                   device=s.device),
        torch.full((3,), cfg.process_noise_phi, dtype=s.dtype,
                   device=s.device),
        torch.full((3,), cfg.process_noise_vel, dtype=s.dtype,
                   device=s.device),
    ])) * torch.clamp(gap, min=1.0)
    cov = F @ ekf.cov @ F.T + Q
    return EKFState(torch.cat([p1, q1, v1]), cov)


def update(ekf: EKFState, lm_xyz, uv_meas, obs_valid, intrinsics,
           cfg: EKFConfig = EKFConfig()) -> EKFState:
    """Measurement update with up to max_obs_per_knot pixel observations:
    the tangent reprojection Jacobian (the factor's Gq lift is twice the
    exp-map differential on the phi block, hence the 0.5); invalid
    observations get a noise of 1e18 px² (no gain)."""
    D = uv_meas.shape[0]
    rp = factors.reprojection_factor(
        ekf.state[None], lm_xyz,
        torch.zeros(D, dtype=torch.int64, device=lm_xyz.device), intrinsics)
    H = rp.J.reshape(D * 2, 9).clone()
    H[:, 3:6] *= 0.5
    r = (uv_meas - rp.uv).reshape(D * 2)
    rmask = obs_valid.repeat_interleave(2)
    Rdiag = torch.where(rmask > 0,
                        torch.full_like(rmask, cfg.meas_noise_px ** 2),
                        torch.full_like(rmask, 1e18))
    S = H @ ekf.cov @ H.T + torch.diag(Rdiag)
    K = ekf.cov @ H.T @ _inv(S)
    dx = K @ (r * rmask)
    pos = ekf.state[:3] + dx[0:3]
    q = quat.box_plus(ekf.state[3:7], dx[3:6])
    vel = ekf.state[7:10] + dx[6:9]
    cov = (torch.eye(9, dtype=ekf.cov.dtype, device=ekf.cov.device)
           - K @ H) @ ekf.cov
    return EKFState(torch.cat([pos, q, vel]), cov)


def run_filter(state0, cov0, gaps, cum_rots, lm_xyz_per_knot, uv_per_knot,
               obs_valid_per_knot, intrinsics,
               cfg: EKFConfig = EKFConfig(), return_predicted: bool = False):
    """The filter over N knots: predict across gaps[t] (the gap BEFORE
    knot t; gaps[0] = 0), then update with knot t's observation buffers
    (N, max_obs, ...).  Returns (N, 10) filtered states and (N, 9, 9)
    covariances, plus the predicted states and covariances with
    return_predicted (for the smoother)."""
    hops = [_hops(g, cfg) for g in gaps.tolist()]
    ekf = EKFState(state0, cov0)
    out = []
    for t in range(gaps.shape[0]):
        pred = predict(ekf, gaps[t], cum_rots[t], cfg, hops[t])
        ekf = update(pred, lm_xyz_per_knot[t], uv_per_knot[t],
                     obs_valid_per_knot[t], intrinsics, cfg)
        out.append((ekf.state, ekf.cov, pred.state, pred.cov))
    states, covs, pstates, pcovs = (torch.stack(a) for a in zip(*out))
    if return_predicted:
        return states, covs, pstates, pcovs
    return states, covs


def _transition_F(state, gap, cum_rot, cfg: EKFConfig, num_hops=None):
    """9x9 tangent transition Jacobian of `predict` at `state`."""
    return _transition(state, gap, cum_rot, cfg,
                       cfg.num_hops if num_hops is None else num_hops)[2]


def run_smoother(state0, cov0, gaps, cum_rots, lm_xyz_per_knot, uv_per_knot,
                 obs_valid_per_knot, intrinsics,
                 cfg: EKFConfig = EKFConfig()):
    """Rauch–Tung–Striebel smoother: the forward filter, then backward in
    tangent space
        G_t = P_t F_{t+1}ᵀ P⁻_{t+1}⁻¹
        x_s_t = x_t ⊞ G_t (x_s_{t+1} ⊟ x⁻_{t+1})
        P_s_t = P_t + G_t (P_s_{t+1} - P⁻_{t+1}) G_tᵀ.
    Returns (N, 10) smoothed states and (N, 9, 9) covariances."""
    states, covs, pstates, pcovs = run_filter(
        state0, cov0, gaps, cum_rots, lm_xyz_per_knot, uv_per_knot,
        obs_valid_per_knot, intrinsics, cfg, return_predicted=True)
    hops = [_hops(g, cfg) for g in gaps.tolist()]

    def boxminus(xa, xb):
        dq = quat.multiply(quat.conjugate(xb[3:7]), xa[3:7])
        return torch.cat([xa[:3] - xb[:3], quat.log(quat.normalize(dq)),
                          xa[7:10] - xb[7:10]])

    xs_next, Ps_next = states[-1], covs[-1]
    xs, Ps = [xs_next], [Ps_next]
    for t in reversed(range(states.shape[0] - 1)):
        F = _transition_F(states[t], gaps[t + 1], cum_rots[t + 1], cfg,
                          hops[t + 1])
        G = covs[t] @ F.T @ _inv(pcovs[t + 1])
        d = G @ boxminus(xs_next, pstates[t + 1])
        x_t = states[t]
        xs_next = torch.cat([x_t[:3] + d[:3],
                             quat.box_plus(x_t[3:7], d[3:6]),
                             x_t[7:10] + d[6:9]])
        Ps_next = covs[t] + G @ (Ps_next - pcovs[t + 1]) @ G.T
        xs.append(xs_next)
        Ps.append(Ps_next)
    return torch.stack(xs[::-1]), torch.stack(Ps[::-1])
