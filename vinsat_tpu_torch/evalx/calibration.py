"""Covariance calibration via NEES tracking (port of
vinsat_tpu/evalx/calibration.py).

The terminal window marginal (`ba.terminal_marginal_info`) is a CRLB-style
information matrix under independent pixel noise, so the raw marginal is
overconfident against the stream's actual (bias-dominated) error.  This
module measures that and turns it into inflation factors:

  * `nees(est, gt, H9)`: e^T H e of one state against its information
    (consistent estimator: E = 9);
  * `block_nees(est, gt, H9)`: per-block (pos / rot / vel) NEES on each
    3-dof block's marginal information (Schur complement);
  * `calibrate_inflation(infos, ests, gts)`: per-block covariance
    inflation factors c with mean block NEES == dof after inflating, and
    `apply_inflation(H9, c)` to use them;
  * `floors_from_inflation(infos, c)`: the equivalent
    `StreamingConfig.prior_*_floor` values.

Numpy in and out, as the stream driver holds these at window boundaries;
the rotation error takes the port's quaternion log and product on CPU f64
tensors.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from vinsat_tpu_torch.core import quat

_BLOCKS = {"pos": slice(0, 3), "rot": slice(3, 6), "vel": slice(6, 9)}


def pose_error_tangent(est_state: np.ndarray, gt_state: np.ndarray
                       ) -> np.ndarray:
    """Tangent-space error [dpos_km, dphi, dvel] of one (10,) state pair;
    dphi = log(conj(q_gt) ⊗ q_est), so that est = gt ⊞ dphi (the solver's
    retraction)."""
    est = np.asarray(est_state, np.float64)
    gt = np.asarray(gt_state, np.float64)
    q_gt, q_est = (torch.as_tensor(q, dtype=torch.float64)
                   for q in (gt[3:7], est[3:7]))
    dphi = quat.log(quat.multiply(quat.conjugate(q_gt), q_est)).numpy()
    return np.concatenate([est[:3] - gt[:3], dphi, est[7:10] - gt[7:10]])


def nees(est_state: np.ndarray, gt_state: np.ndarray, H9: np.ndarray
         ) -> float:
    """Full-state NEES e^T H e (consistent estimator: E = 9)."""
    e = pose_error_tangent(est_state, gt_state)
    return float(e @ np.asarray(H9, np.float64) @ e)


def _cov(H9: np.ndarray) -> np.ndarray:
    return np.linalg.inv(np.asarray(H9, np.float64) + 1e-12 * np.eye(9))


def _marginal_block_info(H9: np.ndarray, sl: slice) -> np.ndarray:
    """3x3 marginal information of one block: inv(cov_block)."""
    return np.linalg.inv(_cov(H9)[sl, sl])


def block_nees(est_state: np.ndarray, gt_state: np.ndarray, H9: np.ndarray
               ) -> dict:
    """Per-block NEES {pos, rot, vel} (consistent: E = 3 each)."""
    e = pose_error_tangent(est_state, gt_state)
    return {name: float(e[sl] @ _marginal_block_info(H9, sl) @ e[sl])
            for name, sl in _BLOCKS.items()}


def calibrate_inflation(infos: Sequence[np.ndarray],
                        ests: Sequence[np.ndarray],
                        gts: Sequence[np.ndarray]) -> dict:
    """Per-block covariance inflation factors c_X = mean_w(nees_X_w) / 3
    (c >> 1: an overconfident marginal; c < 1: a pessimistic one)."""
    samples = {name: [] for name in _BLOCKS}
    for H9, est, gt in zip(infos, ests, gts):
        bn = block_nees(est, gt, H9)
        for name in _BLOCKS:
            samples[name].append(bn[name])
    return {name: float(np.mean(v) / 3.0) for name, v in samples.items()}


def apply_inflation(H9: np.ndarray, c: dict) -> np.ndarray:
    """Inflate a 9x9 information matrix's covariance blockwise:
    cov' = S cov S with S = diag(sqrt(c_X)) per block (correlations
    kept)."""
    s = np.concatenate([np.full(3, np.sqrt(max(c[name], 1e-12)))
                        for name in ("pos", "rot", "vel")])
    return np.linalg.inv(_cov(H9) * s[:, None] * s[None, :])


def floors_from_inflation(infos: Sequence[np.ndarray], c: dict
                          ) -> Tuple[float, float, float]:
    """Equivalent `StreamingConfig` floors (pos_km, rot, vel):
    floor_X² = (c_X - 1) · median_w(mean diag cov_X_w); an inflation < 1
    maps to floor 0 (additive floors cannot shrink a covariance)."""
    diags = {name: [] for name in _BLOCKS}
    for H9 in infos:
        cov = _cov(H9)
        for name, sl in _BLOCKS.items():
            diags[name].append(float(np.mean(np.diag(cov)[sl])))
    return tuple(
        float(np.sqrt(max(c[name] - 1.0, 0.0) * float(np.median(diags[name]))))
        for name in ("pos", "rot", "vel"))
