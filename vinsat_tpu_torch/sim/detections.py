"""Synthetic landmark-detection stream (port of vinsat_tpu/sim/detections.py).

Per frame of the arc:
  1. the imaging gate: all four footprint corners hit the Earth and at
     least `min_visible` accepted landmarks lie in the footprint box (the
     count is kernel K3, kernels/visible_count);
  2. every accepted landmark projected into the gated frames, in-view ones
     kept;
  3. up to `max_dets` of them chosen by a random score, with Gaussian pixel
     noise and a uniform confidence;
  4. the rows [frame, lon, lat, xc, yc, conf] of the reference contract.

The random numbers come from a `DetectionDraws`: by default drawn on the
CPU from a `torch.Generator` (not JAX's threefry stream, so a port seed
gives other detections than a JAX seed), or replayed by `RecordedDraws`
(the JAX package's draws, in the parity tests).  The JAX package draws the
score for all (frame, landmark) pairs; only the in-view pairs of gated
frames can be chosen, so the port draws the score there alone: the chosen
subset is the same in distribution, a uniformly random ordered subset.

Only gated frames are projected, in chunks of frames, with the landmarks'
ECEF computed once.  Slots that hold no detection (`valid` false) carry
NaN pixels; `to_rows` drops them.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from vinsat_tpu_torch.core import frames
from vinsat_tpu_torch.kernels.visible_count import visible_count
from vinsat_tpu_torch.sim import camera as cam_mod
from vinsat_tpu_torch.sim import landmarks as lm_mod
from vinsat_tpu_torch.sim import mgrs
from vinsat_tpu_torch.sim.orbits import Trajectory

# (frame, landmark) pairs projected at once: bounds the (n, L, 2) f64
# intermediates to a few hundred MB however large the arc and the DB
_CHUNK_PAIRS = 1 << 22


class FrameDetections(NamedTuple):
    """Fixed-budget per-frame detections (Tf frames, D = max_dets slots)."""

    valid: torch.Tensor  # (Tf, D) bool
    landmark_idx: torch.Tensor  # (Tf, D) int64 into the LandmarkDB
    uv: torch.Tensor  # (Tf, D, 2) noisy pixel centre
    uv_true: torch.Tensor  # (Tf, D, 2) noise-free projection
    conf: torch.Tensor  # (Tf, D)
    frame_visible: torch.Tensor  # (Tf,) imaging gate passed


class DetectionDraws:
    """The random numbers of the detection stage, drawn in float64 on the
    CPU from `generator` (so one seed gives one stream on any device) and
    moved to the device of the request."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def score(self, frame_idx, lm_idx):
        """Selection scores in [0, 1) of the (frame, landmark) pairs given
        in row-major order; frame_idx counts the arc's strided frames."""
        return torch.rand(len(frame_idx), generator=self.generator,
                          dtype=torch.float64).to(frame_idx.device)

    def noise_conf(self, valid):
        """Standard-normal pixel noise (Tf, D, 2) and uniform confidence
        draws (Tf, D) for the slots of `valid` (Tf, D)."""
        g = self.generator
        noise = torch.randn((*valid.shape, 2), generator=g,
                            dtype=torch.float64)
        conf = torch.rand(valid.shape, generator=g, dtype=torch.float64)
        return noise.to(valid.device), conf.to(valid.device)


class RecordedDraws(DetectionDraws):
    """Draws made elsewhere, replayed: the scores of the (score_frame,
    score_landmark) pairs, sorted row-major, and the noise (M, 2) and
    confidence draws (M,) of the M valid slots in row-major order.  A
    request outside the record raises."""

    def __init__(self, score_frame, score_landmark, score, noise, conf):
        super().__init__(torch.Generator())
        self._keys = self._key(torch.as_tensor(np.asarray(score_frame)),
                               torch.as_tensor(np.asarray(score_landmark)))
        if len(self._keys) > 1 and not bool(
                (self._keys[1:] > self._keys[:-1]).all()):
            raise ValueError("recorded scores must be sorted row-major")
        self._score = torch.as_tensor(np.asarray(score), dtype=torch.float64)
        self._noise = torch.as_tensor(np.asarray(noise), dtype=torch.float64)
        self._conf = torch.as_tensor(np.asarray(conf), dtype=torch.float64)

    @staticmethod
    def _key(frame_idx, lm_idx):
        return (frame_idx.to(torch.int64) << 32) | lm_idx.to(torch.int64)

    def score(self, frame_idx, lm_idx):
        q = self._key(frame_idx.cpu(), lm_idx.cpu())
        pos = torch.searchsorted(self._keys, q)
        found = pos < len(self._keys)
        found[found.clone()] = self._keys[pos[found]] == q[found]
        if not bool(found.all()):
            raise KeyError("a (frame, landmark) pair has no recorded score")
        return self._score[pos].to(frame_idx.device)

    def noise_conf(self, valid):
        n = int(valid.sum())
        if n != len(self._conf):
            raise ValueError(f"{n} valid slots, {len(self._conf)} recorded")
        noise = torch.zeros((*valid.shape, 2), dtype=torch.float64)
        conf = torch.zeros(valid.shape, dtype=torch.float64)
        v = valid.cpu()
        noise[v] = self._noise
        conf[v] = self._conf
        return noise.to(valid.device), conf.to(valid.device)


def _frame_gate(cam: cam_mod.CameraModel, db: lm_mod.LandmarkDB, pos_ecef_m,
                accepted, min_visible: int):
    """Imaging gate of frames at pos_ecef_m (F, 3): all four footprint
    corners hit and >= min_visible `accepted` landmarks in the footprint
    box.  Returns (gate (F,) bool, count (F,) int32); the count is kernel
    K3 for CUDA tensors, its plain twin for CPU tensors."""
    bounds, all_hit = cam_mod.footprint_bounds(
        cam, cam_mod.CameraPose.nadir(pos_ecef_m))
    count = visible_count(bounds.contiguous(), db.lon, db.lat, accepted)
    return all_hit & (count >= min_visible), count


def _project_frame(cam: cam_mod.CameraModel, lm_ecef_m, accepted,
                   pos_ecef_m):
    """Project the landmarks lm_ecef_m (L, 3) into frames at pos_ecef_m
    (n, 3): in-view mask of the accepted ones (n, L) and pixels (n, L, 2)."""
    uv, z = cam_mod.world_to_pixel(cam, cam_mod.CameraPose.nadir(pos_ecef_m),
                                   lm_ecef_m)
    u, v = uv[..., 0], uv[..., 1]
    in_view = ((z > 0) & (u >= 0) & (u < cam.width_px) & (v >= 0)
               & (v < cam.height_px) & accepted)
    return in_view, uv


def select_detections(in_view, uv, score, max_dets: int):
    """The deterministic core of the choice: up to max_dets in-view
    landmarks per frame, in decreasing `score` (n, L) order (the JAX
    package's argsort of the negated score; the score of out-of-view pairs
    is below every in-view one).  Returns (landmark_idx (n, D), valid
    (n, D), uv_true (n, D, 2))."""
    top = torch.topk(score, min(max_dets, score.shape[-1]), dim=-1).indices
    return (top, in_view.gather(1, top),
            uv.gather(1, top[..., None].expand(-1, -1, 2)))


def generate_detections(draws, traj: Trajectory, db: lm_mod.LandmarkDB,
                        cam: Optional[cam_mod.CameraModel] = None,
                        noise_px: float = 4.0,
                        conf_low: float = 0.5, conf_high: float = 1.0,
                        min_visible: int = 3, max_dets: int = 8,
                        frame_stride: int = 1,
                        detector_fn: Optional[Callable] = None,
                        region_mask=None) -> FrameDetections:
    """Simulate the detection stream of a trajectory on its device.

    draws: a DetectionDraws, or a CPU torch.Generator to draw from.
    detector_fn, if given, maps (uv_true, generator) -> (uv_noisy, conf)
    and replaces the Gaussian pixel noise and uniform confidence.
    region_mask overrides the 16-active-region gate; a mask of all True
    treats every region as having a trained detector.
    """
    if isinstance(draws, torch.Generator):
        draws = DetectionDraws(draws)
    if cam is None:
        cam = cam_mod.CameraModel.from_hfov()
    dev = traj.pos_eci.device
    active = (mgrs.active_region_mask(dev) if region_mask is None
              else region_mask)
    accepted = db.best & active[db.region]
    pos = (traj.pos_ecef * 1000.0)[::frame_stride]
    Tf, L = pos.shape[0], db.num_landmarks
    D = min(max_dets, L)

    gate, _ = _frame_gate(cam, db, pos, accepted, min_visible)
    lm_ecef_m = frames.geodetic_to_ecef(db.lat, db.lon) * 1000.0
    landmark_idx = torch.arange(D, device=dev).expand(Tf, D).clone()
    valid = torch.zeros((Tf, D), dtype=torch.bool, device=dev)
    uv_true = torch.full((Tf, D, 2), math.nan, dtype=pos.dtype, device=dev)
    gated = torch.nonzero(gate)[:, 0]
    step = max(1, _CHUNK_PAIRS // max(L, 1))
    for c0 in range(0, len(gated), step):
        f = gated[c0:c0 + step]
        in_view, uv = _project_frame(cam, lm_ecef_m, accepted, pos[f])
        rows, cols = torch.nonzero(in_view, as_tuple=True)
        score = torch.full(in_view.shape, -1.0, dtype=torch.float64,
                           device=dev)
        score[rows, cols] = draws.score(f[rows], cols)
        landmark_idx[f], valid[f], uv_true[f] = select_detections(
            in_view, uv, score, D)

    if detector_fn is None:
        noise, conf_u = draws.noise_conf(valid)
        uv_noisy = uv_true + noise_px * noise
        conf = conf_low + (conf_high - conf_low) * conf_u
    else:
        uv_noisy, conf = detector_fn(uv_true, draws.generator)
    return FrameDetections(valid=valid, landmark_idx=landmark_idx,
                           uv=uv_noisy, uv_true=uv_true, conf=conf,
                           frame_visible=gate)


def to_rows(dets: FrameDetections, db: lm_mod.LandmarkDB,
            frame_stride: int = 1) -> np.ndarray:
    """The valid detections as the reference's rows: (M, 6) float64
    [frame, lon, lat, xc, yc, conf], frame-major."""
    valid = dets.valid.cpu().numpy()
    t_idx, d_idx = np.nonzero(valid)
    li = dets.landmark_idx.cpu().numpy()[t_idx, d_idx]
    uv = dets.uv.cpu().numpy()[t_idx, d_idx]
    return np.stack([
        t_idx.astype(np.float64) * frame_stride,
        db.lon.cpu().numpy()[li],
        db.lat.cpu().numpy()[li],
        uv[:, 0], uv[:, 1],
        dets.conf.cpu().numpy()[t_idx, d_idx],
    ], axis=1)


def px_error_stats(dets: FrameDetections) -> dict:
    """Mean / median / max |pixel error| of the valid detections."""
    valid = dets.valid.cpu().numpy()
    err = np.abs(dets.uv.cpu().numpy() - dets.uv_true.cpu().numpy())[valid]
    if err.size == 0:
        return {"n": 0}
    return {
        "n": int(valid.sum()),
        "mean_x": float(err[:, 0].mean()),
        "mean_y": float(err[:, 1].mean()),
        "median_x": float(np.median(err[:, 0])),
        "median_y": float(np.median(err[:, 1])),
        "max_x": float(err[:, 0].max()),
        "max_y": float(err[:, 1].max()),
    }
