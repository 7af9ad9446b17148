"""End-to-end entry points of the port (vinsat_tpu/pipeline.py):
`simulate_sequence` (the detection simulator) and `run_streaming`
(streaming orbit determination).

A stream's inputs come as (det_rows, orbit_pos_eci_km) arrays, an object
carrying those two attributes (a SimulatedSequence, the port's or the JAX
package's), or a mapping with those keys such as the committed fixture
tests/data/torch_stream_seed1.npz.

The simulator draws from a CPU `torch.Generator` seeded with `seed`, not
from JAX's threefry stream: a port seed gives another orbit, database and
detections than the same JAX seed, and the same ones on every device.
`simulate_from_draws` is its deterministic core, which the parity tests
feed with the JAX package's own draws.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vinsat_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from vinsat_tpu_torch.core import frames
from vinsat_tpu_torch.estimation.window import (StreamingConfig,
                                                StreamingResult, stream_orbit)
from vinsat_tpu_torch.sim import detections as det_mod
from vinsat_tpu_torch.sim import landmarks as lm_mod
from vinsat_tpu_torch.sim import mgrs, orbits


def track_landmark_db(traj: orbits.Trajectory, seed: int, every_s: int = 60,
                      per_point: int = 4, spread_deg: float = 0.5,
                      pass_every_s: Optional[int] = None,
                      pass_len_s: int = 300) -> lm_mod.LandmarkDB:
    """A landmark DB scattered along the trajectory's ground track, on the
    trajectory's device: `per_point` landmarks within ~spread_deg of the
    sub-satellite point every `every_s` seconds, drawn with numpy's
    `default_rng(seed)` as the JAX package does from the int it derives
    from its key.  All landmarks are accepted, so detection yield is
    guaranteed whatever regions the orbit crosses.

    pass_every_s: if set, landmarks exist only under the track segments
    [k*pass_every_s, k*pass_every_s + pass_len_s): periodic region passes
    with long detection gaps between them, hence multi-window streaming."""
    pos_ecef = traj.pos_ecef.cpu().numpy()
    idx = np.arange(0, pos_ecef.shape[0], every_s)
    if pass_every_s is not None:
        idx = idx[(idx % pass_every_s) < pass_len_s]
    # host numpy geodetic inverse, the JAX package's arithmetic
    x, y, z = pos_ecef[idx, 0], pos_ecef[idx, 1], pos_ecef[idx, 2]
    lon = np.rad2deg(np.arctan2(y, x))
    p = np.sqrt(x**2 + y**2)
    lat_r = np.arctan2(z, p * (1.0 - frames.WGS84_E2))
    for _ in range(5):
        sl = np.sin(lat_r)
        N = frames.WGS84_A_KM / np.sqrt(1.0 - frames.WGS84_E2 * sl**2)
        alt = p / np.cos(lat_r) - N
        lat_r = np.arctan2(z, p * (1.0 - frames.WGS84_E2 * N / (N + alt)))
    lat = np.rad2deg(lat_r)
    rng = np.random.default_rng(seed)
    lons = (lon[:, None] + rng.normal(size=(len(idx), per_point))
            * spread_deg).ravel()
    lats = (lat[:, None] + rng.normal(size=(len(idx), per_point))
            * spread_deg).ravel()
    lats = np.clip(lats, -79.0, 79.0)
    n = len(lons)
    reg = mgrs.zone_of(torch.as_tensor(lons), torch.as_tensor(lats)).numpy()
    half = 0.01
    return lm_mod.db_from_numpy(dict(
        lon=lons, lat=lats,
        bbox=np.stack([lons - half, lats - half, lons + half, lats + half],
                      axis=1),
        region=np.where(reg < 0, 0, reg), cls=np.arange(n),
        best=np.ones(n, bool), saliency=np.ones(n)), traj.pos_eci.device)


class SimDraws(NamedTuple):
    """Every random number of one simulated sequence: orbital elements,
    initial attitude q0 (4,) and body rates w0 (3,), the int seed of the
    landmark DB, and the detection stage's draws."""

    oe: orbits.OrbitalElements
    q0: np.ndarray
    w0: np.ndarray
    db_seed: int
    detection: det_mod.DetectionDraws


def draw_sim(seed: int) -> SimDraws:
    """The draws of simulate_sequence(seed), from one CPU torch.Generator:
    elements, attitude, DB seed, then the detection stage's draws."""
    g = torch.Generator().manual_seed(seed)
    oe = orbits.sample_random_oe(g)
    q0, w0 = orbits.sample_attitude(g)
    db_seed = int(torch.randint(0, 2**31 - 1, (), generator=g))
    return SimDraws(oe, q0.numpy(), w0.numpy(), db_seed,
                    det_mod.DetectionDraws(g))


class SimulatedSequence(NamedTuple):
    det_rows: np.ndarray  # (M, 6) [frame, lon, lat, xc, yc, conf]
    orbit_pos_eci_km: np.ndarray  # (T, 3)
    traj: orbits.Trajectory
    db: lm_mod.LandmarkDB
    dets: det_mod.FrameDetections


def simulate_from_draws(draws: SimDraws, duration_s: int = 10800,
                        db: Optional[lm_mod.LandmarkDB] = None,
                        noise_px: float = 4.0, frame_stride: int = 1,
                        max_dets: int = 8, along_track: bool = False,
                        pass_every_s: Optional[int] = None,
                        pass_len_s: int = 300,
                        device=DEFAULT_DEVICE) -> SimulatedSequence:
    """simulate_sequence's deterministic core: one detection sequence from
    its draws, in f64 on `device`."""
    device = resolve_device(device)
    traj = orbits.trajectory_from_draws(draws.oe, draws.q0, draws.w0,
                                        duration_s, device=device)
    region_mask = None
    if db is None:
        if along_track:
            db = track_landmark_db(traj, draws.db_seed,
                                   pass_every_s=pass_every_s,
                                   pass_len_s=pass_len_s)
            region_mask = torch.ones(len(mgrs.ZONE_LABELS), dtype=torch.bool,
                                     device=device)
        else:
            db = lm_mod.synthesize(draws.db_seed, device=device)
    dets = det_mod.generate_detections(
        draws.detection, traj, db, noise_px=noise_px, max_dets=max_dets,
        conf_low=0.82,  # post-gate confidences (the OD gate keeps conf > 0.8)
        frame_stride=frame_stride, region_mask=region_mask)
    rows = det_mod.to_rows(dets, db, frame_stride)
    return SimulatedSequence(rows, traj.pos_eci.cpu().numpy(), traj, db,
                             dets)


def simulate_sequence(seed: int, duration_s: int = 10800,
                      db: Optional[lm_mod.LandmarkDB] = None,
                      noise_px: float = 4.0, frame_stride: int = 1,
                      max_dets: int = 8, along_track: bool = False,
                      pass_every_s: Optional[int] = None,
                      pass_len_s: int = 300,
                      device=DEFAULT_DEVICE) -> SimulatedSequence:
    """One detection sequence over a random LEO orbit, ground truth in f64
    on `device`.

    Without `db`, landmarks come from `landmarks.synthesize` over the 16
    detector-active regions (many seeds then see no landmark at all), or,
    with along_track=True, from `track_landmark_db` under the actual
    ground track with every region active, which guarantees detections;
    pass_every_s / pass_len_s restrict those to periodic track segments
    (detection gaps, multi-window streaming).
    """
    return simulate_from_draws(
        draw_sim(seed), duration_s, db=db, noise_px=noise_px,
        frame_stride=frame_stride, max_dets=max_dets,
        along_track=along_track, pass_every_s=pass_every_s,
        pass_len_s=pass_len_s, device=device)


def stream_inputs(seq) -> Tuple[np.ndarray, np.ndarray]:
    """(det_rows, orbit_pos_eci_km) from any of the accepted input forms."""
    if hasattr(seq, "det_rows"):
        det_rows, orbit = seq.det_rows, seq.orbit_pos_eci_km
    elif isinstance(seq, Mapping) or hasattr(seq, "files"):
        det_rows, orbit = seq["det_rows"], seq["orbit_pos_eci_km"]
    else:
        det_rows, orbit = seq
    return (np.asarray(det_rows, np.float64),
            np.asarray(orbit, np.float64))


def run_streaming(seq, seed: int = 0,
                  cfg: StreamingConfig = StreamingConfig(),
                  device=DEFAULT_DEVICE) -> StreamingResult:
    """Streaming orbit determination of one sequence on `device`."""
    det_rows, orbit = stream_inputs(seq)
    return stream_orbit(det_rows, orbit, seed=seed, cfg=cfg, device=device)
