"""Terminal-error information bound (CRLB) per orbit (port of
vinsat_tpu/evalx/crlb.py; the model and its derivation are documented
there).

The orbit's initial [pos, vel] x0 is the unknown; each gated detection adds
Fisher information (1/σ_px²) J_mᵀ J_m with J_m = d uv / d x0, chained
through the RK4 transition sensitivity Φ_k = d x_k / d x0
(refine._rollout_with_sensitivity).  The terminal covariance is
Φ_T H⁻¹ Φ_Tᵀ with Φ_T carried through the open-loop tail to the arc end,
and the bound is sqrt(tr Cov_pos).  A companion bound adds the initial
attitude as a 3-dof unknown carried through the known attitude chain (the
rigid-chain tail estimator's own family) and marginalizes it out.

Everything runs in f64 on `device`; the 6×6 and 9×9 information matrices
are inverted Jacobi-scaled with torch.linalg.inv.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from vinsat_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from vinsat_tpu_torch.core import quat
from vinsat_tpu_torch.estimation import factors, ingest
from vinsat_tpu_torch.estimation.refine import _rollout_with_sensitivity


# the JAX module's default camera: fx = fy 2.3e-3 px above the reference
# camera's REFERENCE_INTRINSICS (config.py), kept so that both packages
# bound the same sequence alike
CRLB_INTRINSICS = (3547.8512126219637, 3547.8512126219637, 2304.0, 1296.0)


def _scaled_inv(H):
    """Jacobi-scaled inverse (pos ~1e3 km against vel ~1 km/s scales)."""
    s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-30))
    S = s[:, None] * s[None, :]
    return torch.linalg.inv(H * S) * S


def _pos_bound(Phi, cov0) -> float:
    covT = Phi @ cov0 @ Phi.T
    return float(torch.sqrt(torch.clamp(torch.trace(covT[:3, :3]), min=0.0)))


def terminal_crlb_km(orbit_pos_eci_km: np.ndarray, det_rows: np.ndarray,
                     noise_px: float = 4.0,
                     intrinsics=CRLB_INTRINSICS,
                     max_substep: float = 100.0,
                     device=DEFAULT_DEVICE) -> dict:
    """Information bound on the terminal (arc-end) position error of one
    detection sequence, evaluated at the ground truth.

    Returns {"crlb_final_km", "crlb_last_knot_km", "crlb_att_final_km",
    "n_obs", "obs_span_s"}, with NaN bounds when no observation survives
    the gate (or fewer than two knots remain)."""
    device = resolve_device(device)
    dtype = torch.float64

    def t(a, dt=dtype):
        return torch.tensor(np.asarray(a), dtype=dt, device=device)

    T = orbit_pos_eci_km.shape[0]
    graph = ingest.build_graph(det_rows, T)
    gt = ingest.process_ground_truths(orbit_pos_eci_km, graph, device=device)
    intr = t(np.asarray(intrinsics, np.float64))
    uv_proj = factors.project_landmarks(
        t(gt.states), t(gt.landmarks_xyz), t(graph.ii, torch.int64),
        intr).cpu().numpy()
    graph, gt, _ = ingest.gate_and_compact(graph, gt, uv_proj)
    M = len(graph.ii)
    if M == 0 or len(graph.time_idx) < 2:
        return {"crlb_final_km": math.nan, "crlb_last_knot_km": math.nan,
                "crlb_att_final_km": math.nan, "n_obs": int(M),
                "obs_span_s": 0.0}

    # the knot chain + the open-loop tail to the arc end as one extra gap
    knot_t = np.asarray(graph.time_idx, np.float64)
    tail = float(T - 1 - knot_t[-1])
    gaps_all = np.concatenate([np.diff(knot_t), [max(tail, 0.0)]])
    x0 = t(np.concatenate([gt.states[0, :3], gt.states[0, 7:10]]))
    hops = int(np.ceil(max(float(gaps_all.max()), 1.0) / max_substep)) + 1
    _, Phis = _rollout_with_sensitivity(x0, gaps_all, hops, max_substep)
    # Phis rows: [x0, knot_1 .. knot_{N-1}, arc end]

    st10 = t(gt.states)
    ii = t(graph.ii, torch.int64)
    rp = factors.reprojection_factor(st10, t(gt.landmarks_xyz), ii, intr)
    Jm = torch.einsum("mij,mjk->mik", rp.J[:, :, 0:3],
                      Phis[ii][:, 0:3, :])  # (M, 2, 6)
    H = torch.einsum("mki,mkj->ij", Jm, Jm) / (noise_px ** 2)
    cov0 = _scaled_inv(H)

    # 9 dof: + the initial-attitude correction carried through the known
    # attitude chain, R(C_i)^T = R(q_i)^T R(q_0)
    R_all = quat.to_matrix(st10[:, 3:7])  # (N, 3, 3)
    Rt = torch.einsum("nji,jk->nik", R_all, R_all[0])
    Jphi = torch.einsum("mij,mjk->mik", rp.J[:, :, 3:6], Rt[ii])
    J9 = torch.cat([Jm, Jphi], dim=-1)  # (M, 2, 9)
    H9 = torch.einsum("mki,mkj->ij", J9, J9) / (noise_px ** 2)
    cov9 = _scaled_inv(H9)[:6, :6]  # attitude marginalized out

    return {
        "crlb_final_km": _pos_bound(Phis[-1], cov0),
        "crlb_last_knot_km": _pos_bound(Phis[-2], cov0),
        "crlb_att_final_km": _pos_bound(Phis[-1], cov9),
        "n_obs": int(M),
        "obs_span_s": float(knot_t[-1] - knot_t[0]),
    }


def efficiency(crlb_km: float, actual_km: float) -> float:
    """crlb / actual in (0, 1]: 1 = at the information limit."""
    if not np.isfinite(crlb_km) or not np.isfinite(actual_km) \
            or actual_km <= 0:
        return float("nan")
    return min(crlb_km / actual_km, 1.0)
