"""EKF+BA hybrid streaming (port of vinsat_tpu/estimation/hybrid.py;
BASELINE config 3's "EKF+BA hybrid").

Between windows the EKF predict chain carries the last window's posterior
(its terminal state and the 9x9 information of its anchor) knot by knot
across the gap, and the update chain refines those states with the new
window's own pixel observations.  Window BA then runs as BA_reg from that
warm start with the anchor-only marginal prior (window.stream_orbit):
per-knot EKF-posterior priors would count the window's detections twice,
since BA observes them again.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vinsat_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from vinsat_tpu_torch.estimation import ba, ekf


def build_knot_obs_buffers(graph, gt, t_init: int, t_final: int,
                           max_obs: int = 8
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fixed-budget per-knot observation buffers for knots
    [t_init, t_final): (Nw, D, 3) landmark ECI, (Nw, D, 2) uv, (Nw, D)
    valid; a knot keeps its first max_obs observations."""
    Nw = t_final - t_init
    lm = np.zeros((Nw, max_obs, 3))
    uv = np.zeros((Nw, max_obs, 2))
    ov = np.zeros((Nw, max_obs))
    fill = np.zeros(Nw, dtype=int)
    sel = np.nonzero((graph.ii >= t_init) & (graph.ii < t_final))[0]
    for j in sel:
        k = int(graph.ii[j]) - t_init
        if fill[k] >= max_obs:
            continue
        lm[k, fill[k]] = gt.landmarks_xyz[j]
        uv[k, fill[k]] = graph.uv[j]
        ov[k, fill[k]] = 1.0
        fill[k] += 1
    return lm, uv, ov


def ekf_refine_window(end_state: np.ndarray, last_hessian: np.ndarray,
                      knot_t: np.ndarray, t_init: int, t_final: int,
                      cum_rot: np.ndarray, graph, gt, intrinsics,
                      dtype=torch.float64, num_hops: int = 16,
                      max_substep: float = 100.0,
                      meas_noise_px: float = 5.0, max_obs: int = 8,
                      return_prior: bool = False,
                      device=DEFAULT_DEVICE):
    """EKF predict+update pass over the new knots [t_init, t_final) on
    `device`.

    end_state (10,): the previous window's terminal state; last_hessian
    (9, 9): its information ([pos, phi, vel]); cum_rot (N, 4): the global
    per-gap IMU rotations (cum_rot[i] spans knot i -> i+1).  Returns the
    filtered states (Nw, 10) as host numpy; with return_prior also a
    PriorState over the Nw knots whose information is the inverse EKF
    posterior covariance (the streaming hybrid does not use it: see the
    module docstring)."""
    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    Nw = t_final - t_init
    gaps_before = (knot_t[t_init:t_final]
                   - knot_t[t_init - 1:t_final - 1]).astype(np.float64)
    cum_before = np.asarray(cum_rot)[t_init - 1:t_final - 1]
    lm, uv, ov = build_knot_obs_buffers(graph, gt, t_init, t_final, max_obs)

    # posterior covariance of the previous window's terminal knot
    H = np.asarray(last_hessian, dtype=np.float64) + 1e-9 * np.eye(9)
    cov0 = np.linalg.inv(H)

    cfg = ekf.EKFConfig(meas_noise_px=meas_noise_px, num_hops=num_hops,
                        max_substep=max_substep, max_obs_per_knot=max_obs)
    states, covs = ekf.run_filter(
        t(end_state), t(cov0), t(gaps_before), t(cum_before), t(lm), t(uv),
        t(ov), t(intrinsics), cfg)
    states = states.cpu().numpy()
    if not return_prior:
        return states

    covs = covs.cpu().numpy().astype(np.float64) + 1e-9 * np.eye(9)
    H_state, H_rot = ba.split_info(np.linalg.inv(covs))
    prior = ba.PriorState(t(states), t(H_state), t(H_rot),
                          torch.ones(Nw, dtype=dtype, device=device))
    return states, prior
