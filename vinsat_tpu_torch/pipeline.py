"""End-to-end entry points of the port (vinsat_tpu/pipeline.py):
`simulate_sequence` (the detection simulator), `simulate_sequence_imagery`
(the same through rendered rasters and an image detector), `run_streaming`
(streaming orbit determination), `run_batch_eval` (the orbit-by-orbit
evaluation) and `run_constellation` (BASELINE config 4: B orbits' LM
solves as one batched program).

A stream's inputs come as (det_rows, orbit_pos_eci_km) arrays, an object
carrying those two attributes (a SimulatedSequence, the port's or the JAX
package's), or a mapping with those keys such as the committed fixture
tests/data/torch_stream_seed1.npz.

The simulator draws from a CPU `torch.Generator` seeded with `seed`, not
from JAX's threefry stream: a port seed gives another orbit, database and
detections than the same JAX seed, and the same ones on every device.
`simulate_from_draws` and `simulate_imagery_from_draws` are the
deterministic cores, which the parity tests feed with the JAX package's
own draws.
"""
from __future__ import annotations

import time
from typing import (Callable, List, Mapping, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from vinsat_tpu_torch.config import (DEFAULT_DEVICE, REFERENCE_INTRINSICS,
                                     resolve_device)
from vinsat_tpu_torch.core import frames, quat
from vinsat_tpu_torch.estimation import ba, factors, ingest, window
from vinsat_tpu_torch.estimation.window import (StreamingConfig,
                                                StreamingResult, stream_orbit)
from vinsat_tpu_torch.evalx import ate, crlb
from vinsat_tpu_torch.sim import camera as cam_mod
from vinsat_tpu_torch.sim import detections as det_mod
from vinsat_tpu_torch.sim import imagery
from vinsat_tpu_torch.sim import landmarks as lm_mod
from vinsat_tpu_torch.sim import learned_detector as ld_mod
from vinsat_tpu_torch.sim import mgrs, orbits
from vinsat_tpu_torch.tools.raster import Affine, RasterImageServer


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
                        pass_len_s: int = 300, hifi_truth: bool = False,
                        device=DEFAULT_DEVICE) -> SimulatedSequence:
    """simulate_sequence's deterministic core: one detection sequence from
    its draws, in f64 on `device`."""
    device = resolve_device(device)
    traj = orbits.trajectory_from_draws(draws.oe, draws.q0, draws.w0,
                                        duration_s, device=device,
                                        hifi=hifi_truth)
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
                      pass_len_s: int = 300, hifi_truth: bool = False,
                      device=DEFAULT_DEVICE) -> SimulatedSequence:
    """One detection sequence over a random LEO orbit, ground truth in f64
    on `device`.

    Without `db`, landmarks come from `landmarks.synthesize` over the 16
    detector-active regions (many seeds then see no landmark at all), or,
    with along_track=True, from `track_landmark_db` under the actual
    ground track with every region active, which guarantees detections;
    pass_every_s / pass_len_s restrict those to periodic track segments
    (detection gaps, multi-window streaming).

    hifi_truth=True simulates the orbit with the full force model
    (core/forces.py: drag, SRP, sun / moon third body) while the
    estimator keeps two-body + J2: the model-mismatch configuration.
    """
    return simulate_from_draws(
        draw_sim(seed), duration_s, db=db, noise_px=noise_px,
        frame_stride=frame_stride, max_dets=max_dets,
        along_track=along_track, pass_every_s=pass_every_s,
        pass_len_s=pass_len_s, hifi_truth=hifi_truth, device=device)


class ImageryDraws(NamedTuple):
    """Every random number of one imagery sequence: orbital elements,
    initial attitude and rates, the landmark DB's int seed, the class
    templates (at least as many as the sequence's classes; the first K
    are used) and, for region ci of shape (H, W), its float32 noise
    image `region_noise(ci, H, W)` (0.15 times standard-normal draws)."""

    oe: orbits.OrbitalElements
    q0: np.ndarray
    w0: np.ndarray
    db_seed: int
    templates: torch.Tensor  # (>= K, S, S) float32
    region_noise: Optional[Callable[[int, int, int], torch.Tensor]] = None


def draw_imagery(seed: int, num_landmarks: int = 60) -> ImageryDraws:
    """The draws of simulate_sequence_imagery(seed), from one CPU
    torch.Generator: elements, attitude, DB seed, num_landmarks
    templates of 12 x 12, then each region's noise as stage 0 asks for
    it."""
    g = torch.Generator().manual_seed(seed)
    oe = orbits.sample_random_oe(g)
    q0, w0 = orbits.sample_attitude(g)
    db_seed = int(torch.randint(0, 2**31 - 1, (), generator=g))
    templates = imagery.make_landmark_templates(g, num_landmarks, 12,
                                                device="cpu")
    return ImageryDraws(oe, q0.numpy(), w0.numpy(), db_seed, templates,
                        lambda ci, H, W: 0.15 * torch.randn((H, W),
                                                            generator=g))


class CropDetections(NamedTuple):
    """The crops the detector ran on and its per-crop output."""

    frames: np.ndarray  # (F,) frame (second) of each crop
    windows: np.ndarray  # (F, 6) each crop's transform (a, b, c, d, e, f)
    shapes: np.ndarray  # (F, 2) each crop's (h, w) before padding
    crop_hw: Tuple[int, int]  # the (Hc, Wc) every crop was padded to
    scores: np.ndarray  # (F, K) float32
    rows: np.ndarray  # (F, K) float32
    cols: np.ndarray  # (F, K) float32


class ImagerySequence(NamedTuple):
    det_rows: np.ndarray  # (M, 6) [frame, lon, lat, xc, yc, conf]
    orbit_pos_eci_km: np.ndarray  # (T, 3)
    traj: orbits.Trajectory
    db: lm_mod.LandmarkDB
    crops: Optional[CropDetections]
    stage_s: dict  # seconds of each stage


class _Scene(NamedTuple):
    """Stages 0-2: the regions rendered and registered, every footprint,
    the crops cut."""

    traj: orbits.Trajectory
    db: lm_mod.LandmarkDB
    lon: np.ndarray  # (K,) the classes' landmarks
    lat: np.ndarray
    templates: torch.Tensor  # (K, S, S) float32 on the device
    cam: cam_mod.CameraModel
    poses: cam_mod.CameraPose  # every frame's (f64, on the device)
    crops: List[np.ndarray]  # uint8 (h, w) each
    frames: np.ndarray  # (F,) frame of each crop
    pose_rows: np.ndarray  # (F,) its row in `poses`
    windows: List[Affine]


def _clusters(lon, lat, span_deg: float) -> List[List[int]]:
    """Track-ordered clustering: each landmark joins the last cluster while
    that stays under span_deg in lon and lat, else starts a new one."""
    clusters: List[List[int]] = []
    for k in range(len(lon)):
        if clusters:
            cur = clusters[-1] + [k]
            if (lon[cur].max() - lon[cur].min() < span_deg
                    and lat[cur].max() - lat[cur].min() < span_deg):
                clusters[-1] = cur
                continue
        clusters.append([k])
    return clusters


def _choose_region(b, region_boxes) -> Optional[str]:
    """The region whose box holds the footprint box b's centre, the centre
    brought back into [-180, 180) and tested at lon and lon + 360 (boxes
    over the antimeridian have lon_max > 180; region boxes carry raw
    longitudes with a 1 deg margin, so their east edge can reach 181)."""
    cx = 0.5 * (b[0] + b[2])
    cx = (cx + 180.0) % 360.0 - 180.0
    cy = 0.5 * (b[1] + b[3])
    for name, lo, la0, hi, la1 in region_boxes:
        if (lo <= cx <= hi or lo <= cx + 360.0 <= hi) and la0 <= cy <= la1:
            return name
    return None


def _imagery_scene(draws: ImageryDraws, duration_s: int, frame_stride: int,
                   num_landmarks: int, deg_per_px: float, amplitude: float,
                   max_region_span_deg: float, rasters, device,
                   stage_s: dict) -> _Scene:
    """Stages 0-2 of the imagery path on `device` (f64 ground truth):
    the trajectory and track DB; stage 0, the classes clustered into
    regions of <= max_region_span_deg, each rendered (from
    draws.region_noise, or taken from `rasters`, uint8 (H, W) each) at
    deg_per_px with its shape rounded up to 256; stage 1, every frame's
    footprint in one batched call; stage 2, the host crops of the
    footprints whose centre lies in a region (at least 16 px each way)."""
    t0 = time.perf_counter()
    traj = orbits.trajectory_from_draws(draws.oe, draws.q0, draws.w0,
                                        duration_s, device=device)
    db = track_landmark_db(
        traj, draws.db_seed,
        every_s=max(duration_s // max(num_landmarks // 3, 1), 1),
        per_point=3, spread_deg=0.8)
    lon = db.lon[:num_landmarks].cpu().numpy()
    lat = db.lat[:num_landmarks].cpu().numpy()
    K = len(lon)
    if draws.templates.shape[0] < K:
        raise ValueError(f"templates cover {draws.templates.shape[0]} "
                         f"classes < {K} landmarks")
    templates = draws.templates[:K].to(device=device, dtype=torch.float32)
    stage_s["trajectory"] = time.perf_counter() - t0

    # stage 0: the region rasters
    t0 = time.perf_counter()
    srv = RasterImageServer()
    region_boxes = []
    for ci, cl in enumerate(_clusters(lon, lat, max_region_span_deg)):
        lon0, lon1 = lon[cl].min() - 1.0, lon[cl].max() + 1.0
        lat0, lat1 = lat[cl].min() - 1.0, lat[cl].max() + 1.0
        W = int(np.ceil((lon1 - lon0) / deg_per_px / 256) * 256)
        H = int(np.ceil((lat1 - lat0) / deg_per_px / 256) * 256)
        t = Affine(deg_per_px, 0.0, lon0, 0.0, -deg_per_px, lat1)
        if rasters is not None:
            img8 = np.asarray(rasters[ci] if ci < len(rasters) else [],
                              np.uint8)
            if img8.shape != (H, W):
                raise ValueError(f"raster {ci} is {img8.shape}, region "
                                 f"{ci} needs {(H, W)}")
        else:
            cols, rows_px = t.world_to_pixel(lon, lat)
            # classes outside this raster fall outside the image: not drawn
            img8 = imagery.to_u8(imagery.render_from_draws(
                draws.region_noise(ci, H, W).to(device), templates,
                np.stack([cols, rows_px], 1), amplitude)).cpu().numpy()
        srv.register(f"R{ci}", img8[..., None], t)
        region_boxes.append((f"R{ci}", lon0, lat0, lon1, lat1))
    stage_s["render"] = time.perf_counter() - t0

    # stage 1: every footprint in one batched call
    t0 = time.perf_counter()
    cam = cam_mod.CameraModel.from_hfov()
    frames_idx = np.arange(0, duration_s + 1, frame_stride)
    poses = cam_mod.CameraPose.nadir(
        traj.pos_ecef[torch.as_tensor(frames_idx, device=device)] * 1000.0)
    bounds_b, ok_b = cam_mod.footprint_bounds(cam, poses)
    bounds_b, ok_b = bounds_b.cpu().numpy(), ok_b.cpu().numpy()
    stage_s["footprints"] = time.perf_counter() - t0

    # stage 2: host crops
    t0 = time.perf_counter()
    crops, fis, rows_i, wins = [], [], [], []
    for i, fi in enumerate(frames_idx):
        if not ok_b[i]:
            continue
        b = bounds_b[i]
        region = _choose_region(b, region_boxes)
        if region is None:
            continue
        win, wt = srv.get_window(region, b[0], b[1], b[2], b[3])
        if win is None or min(win.shape[:2]) < 16:
            continue
        crops.append(win[..., 0])
        fis.append(int(fi))
        rows_i.append(i)
        wins.append(wt)
    stage_s["crops"] = time.perf_counter() - t0
    return _Scene(traj, db, lon, lat, templates, cam, poses, crops,
                  np.array(fis, np.int64), np.array(rows_i, np.int64), wins)


def detect_crops(detector, crops: Sequence[np.ndarray],
                 templates: torch.Tensor):
    """Stage 3: every crop, zero-padded to one (Hc, Wc) (each a multiple of
    64), through the detector in chunks of min(16, 2e8 / (K Hc Wc))
    crops, uploaded as uint8 and cast on the device; one host sync in
    all.  detector None is the NCC TemplateDetector over `templates` (K,
    S, S); a TrainedDetector without templates gets `templates` attached
    (the render's class appearances) for its matched-filter stage.
    Returns ((F, K) scores, rows, cols as float32 numpy, (Hc, Wc))."""
    K = templates.shape[0]
    Hc = int(np.ceil(max(c.shape[0] for c in crops) / 64) * 64)
    Wc = int(np.ceil(max(c.shape[1] for c in crops) / 64) * 64)
    chunk = max(1, min(16, int(2e8 / max(K * Hc * Wc, 1))))
    if detector is not None:
        if detector.device != templates.device:
            raise ValueError(f"detector on {detector.device}, crops go to "
                             f"{templates.device}")
        if detector.templates is None:
            detector = detector._replace(
                templates=templates[:detector.num_classes])
    out = []
    for j0 in range(0, len(crops), chunk):
        part = crops[j0:j0 + chunk]
        batch = np.zeros((len(part), Hc, Wc), np.uint8)
        for j, c in enumerate(part):
            batch[j, :c.shape[0], :c.shape[1]] = c
        batch = torch.from_numpy(batch).to(templates.device)
        if detector is None:
            out.append(imagery.correlate_peaks_batch(batch, templates))
        else:
            out.append(tuple(a[:, :K] for a in
                             ld_mod.detect_peaks_batch(detector, batch)))
    scores, rows_, cols_ = (torch.cat(o).cpu().numpy() for o in zip(*out))
    return scores, rows_, cols_, (Hc, Wc)


def _rows_from_detections(scene: _Scene, scores, rows_, cols_,
                          conf_threshold: float, calibrate: bool,
                          stage_s: dict) -> np.ndarray:
    """Stages 4-5: the (F, K) candidates thresholded in one numpy pass
    (score > conf_threshold, inside the unpadded crop) and mapped to lon /
    lat through each crop's transform; then every candidate reprojected
    into its frame's camera in one batched f64 call on the device, the
    rows inside the image kept: [frame, class lon, class lat, u, v, conf],
    conf = 0.5 + 0.5 score for the NCC detector (calibrate), the score as
    it is for the trained one."""
    t0 = time.perf_counter()
    hj = np.array([c.shape[0] for c in scene.crops])[:, None]
    wj = np.array([c.shape[1] for c in scene.crops])[:, None]
    wa = np.array([list(w) for w in scene.windows])
    keep = (scores > conf_threshold) & (rows_ < hj) & (cols_ < wj)
    jsel, ksel = np.nonzero(keep)
    c_sel, r_sel = cols_[jsel, ksel], rows_[jsel, ksel]
    dlon = wa[jsel, 0] * c_sel + wa[jsel, 1] * r_sel + wa[jsel, 2]
    dlat = wa[jsel, 3] * c_sel + wa[jsel, 4] * r_sel + wa[jsel, 5]
    conf = (0.5 + 0.5 * scores[jsel, ksel] if calibrate
            else scores[jsel, ksel])
    stage_s["threshold"] = time.perf_counter() - t0
    if not len(jsel):
        return np.zeros((0, 6))
    t0 = time.perf_counter()
    device = scene.poses.position.device
    sel = torch.as_tensor(scene.pose_rows[jsel], device=device)
    pose = cam_mod.CameraPose(scene.poses.position[sel],
                              scene.poses.R_wc[sel])
    uv, _ = cam_mod.lonlat_to_pixel(
        scene.cam, pose,
        *(torch.as_tensor(a, dtype=torch.float64, device=device)[:, None]
          for a in (dlon, dlat)))
    u, v = uv[:, 0].cpu().numpy().T
    stage_s["reprojection"] = time.perf_counter() - t0
    inside = ((0 <= u) & (u < scene.cam.width_px) & (0 <= v)
              & (v < scene.cam.height_px))
    det = np.stack([scene.frames[jsel], scene.lon[ksel], scene.lat[ksel], u,
                    v, conf.astype(np.float64)], axis=1)
    return det[inside]


def simulate_imagery_from_draws(draws: ImageryDraws, duration_s: int = 600,
                                frame_stride: int = 30,
                                num_landmarks: int = 60,
                                deg_per_px: float = 0.01,
                                conf_threshold: float = 0.55,
                                amplitude: float = 1.5,
                                max_region_span_deg: float = 12.0,
                                detector=None, rasters=None,
                                device=DEFAULT_DEVICE) -> ImagerySequence:
    """simulate_sequence_imagery's deterministic core: stages 0-5 from the
    draws (or, with `rasters`, from the region rasters themselves, uint8
    (H, W) a region in stage 0's order, in place of rendering them), on
    `device`.  Ground truth and reprojection run in f64, rendering and
    detection in f32 with TF32 off."""
    device = resolve_device(device)
    stage_s: dict = {}
    scene = _imagery_scene(draws, duration_s, frame_stride, num_landmarks,
                           deg_per_px, amplitude, max_region_span_deg,
                           rasters, device, stage_s)
    pos_eci = scene.traj.pos_eci.cpu().numpy()
    if not scene.crops:
        return ImagerySequence(np.zeros((0, 6)), pos_eci, scene.traj,
                               scene.db, None, stage_s)
    t0 = time.perf_counter()
    scores, rows_, cols_, crop_hw = detect_crops(detector, scene.crops,
                                                 scene.templates)
    stage_s["detection"] = time.perf_counter() - t0
    det = _rows_from_detections(scene, scores, rows_, cols_, conf_threshold,
                                detector is None, stage_s)
    crops = CropDetections(
        scene.frames, np.array([list(w) for w in scene.windows]),
        np.array([c.shape for c in scene.crops]), crop_hw, scores, rows_,
        cols_)
    return ImagerySequence(det, pos_eci, scene.traj, scene.db, crops,
                           stage_s)


def simulate_sequence_imagery(seed: int, duration_s: int = 600,
                              frame_stride: int = 30,
                              num_landmarks: int = 60,
                              deg_per_px: float = 0.01,
                              conf_threshold: float = 0.55,
                              amplitude: float = 1.5,
                              max_region_span_deg: float = 12.0,
                              detector=None, templates=None,
                              device=DEFAULT_DEVICE) -> ImagerySequence:
    """A detection sequence through the imagery path: region rasters
    rendered along the ground track (landmarks from `track_landmark_db`,
    the first num_landmarks of them the classes, clustered into regions
    of <= max_region_span_deg at deg_per_px), each frame's footprint window
    cropped from its region, the crops through the detector on `device`,
    the detections mapped back to the reference's global rows.

    detector None runs the NCC TemplateDetector (conf_threshold gates the
    raw score in [-1, 1]; confidence 0.5 + 0.5 score); a
    learned_detector.TrainedDetector (on `device`) runs the PatchCNN, its
    scores already confidences.  templates (>= K, S, S) replaces the
    drawn class appearances, e.g. those a committed detector was trained
    on.  Draws from one CPU torch.Generator seeded with `seed`
    (draw_imagery)."""
    draws = draw_imagery(seed, num_landmarks)
    if templates is not None:
        draws = draws._replace(templates=torch.as_tensor(templates))
    return simulate_imagery_from_draws(
        draws, duration_s, frame_stride, num_landmarks, deg_per_px,
        conf_threshold, amplitude, max_region_span_deg, detector,
        device=device)


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


def eval_row(seq, res: StreamingResult, seed: int,
             device=DEFAULT_DEVICE) -> dict:
    """One orbit's row of the evaluation table (bench.py's per-orbit
    columns): detections, min and final error, the terminal information
    bounds (evalx.crlb) and the efficiencies against them, the
    observation span and the recovery trips; unrounded."""
    det_rows, orbit = stream_inputs(seq)
    row = {"seed": seed, "n_dets": len(det_rows)}
    if not len(res.errors):
        return row
    cb = crlb.terminal_crlb_km(orbit, det_rows, device=device)
    final = float(res.errors[-1])
    row.update(
        min_err_km=float(res.errors.min()), final_err_km=final,
        crlb_final_km=cb["crlb_final_km"],
        crlb_att_final_km=cb["crlb_att_final_km"],
        efficiency=crlb.efficiency(cb["crlb_final_km"], final),
        efficiency_att=crlb.efficiency(cb["crlb_att_final_km"], final),
        obs_span_s=cb["obs_span_s"],
        recovery_trips=int(res.recovery_trips))
    return row


def run_batch_eval(seeds: List[int], duration_s: int = 10800,
                   cfg: StreamingConfig = StreamingConfig(),
                   device=DEFAULT_DEVICE) -> dict:
    """The multi-orbit evaluation: each seed simulated (the synthesized
    16-region DB) and streamed in turn, as the JAX package does, then the
    time-to-<5 km summary over the orbits (`ate.summarize`).  Seeds with
    no detection are skipped."""
    errors, times = [], []
    for s in seeds:
        seq = simulate_sequence(s, duration_s, device=device)
        if len(seq.det_rows) == 0:
            continue
        res = run_streaming(seq, seed=s, cfg=cfg, device=device)
        errors.append(res.errors)
        times.append(res.times)
    return ate.summarize(errors, times)


def _noised_states(gt_states: np.ndarray, rng: np.random.Generator,
                   cfg: StreamingConfig, device) -> np.ndarray:
    """Initial knot states: GT plus noise, drawn from `rng` as the JAX
    package draws them (position, attitude through log / exp on `device`
    in f64, then velocity scaled by the mean |GT velocity|)."""
    N = gt_states.shape[0]

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float64, device=device)

    pos0 = gt_states[:, :3] + rng.standard_normal((N, 3)) * cfg.noise_pos_km
    phi = quat.log(t(gt_states[:, 3:7])).cpu().numpy()
    phi = phi + rng.standard_normal((N, 3)) * cfg.noise_ori_rad
    q0 = quat.exp(t(phi)).cpu().numpy()
    vs = np.abs(gt_states[:, 7:10]).mean()
    vel0 = (gt_states[:, 7:10]
            + rng.standard_normal((N, 3)) * vs * cfg.noise_vel_rel)
    return np.concatenate([pos0, q0, vel0], axis=1)


def _gated(det_rows: np.ndarray, orbit: np.ndarray, orbit_len: int, device):
    """The detection graph and GT of one sequence, gated on the GT
    reprojection and compacted: (graph, gt)."""
    graph = ingest.build_graph(det_rows, orbit_len)
    gt = ingest.process_ground_truths(orbit, graph, device=device)
    uv_proj = factors.project_landmarks(
        *(torch.as_tensor(np.asarray(a), device=device) for a in (
            gt.states, gt.landmarks_xyz, graph.ii.astype(np.int64),
            np.array(REFERENCE_INTRINSICS)))).cpu().numpy()
    graph, gt, _ = ingest.gate_and_compact(graph, gt, uv_proj)
    return graph, gt


def run_full_batch(seq, seed: int = 0, num_iters: int = 100,
                   init_iters: int = 10,
                   cfg: StreamingConfig = StreamingConfig(),
                   device=DEFAULT_DEVICE
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Whole-arc optimization (BASELINE config 2, "full-batch BA"): the
    gated graph of the whole sequence as one padded window, num_iters LM
    iterations with schedule index i - init_iters, the first init_iters
    vision-only, the sequential λ search, on `device`: conditioning in
    f64, the solve in cfg.dtype.  Returns (final knot states, knot times,
    GT knot states) as numpy."""
    window._check_supported(cfg)
    device = resolve_device(device)
    dtype = window._DTYPES[cfg.dtype]
    rng = np.random.default_rng(seed)
    det_rows, orbit = stream_inputs(seq)
    graph, gt = _gated(det_rows, orbit, orbit.shape[0], device)
    N = len(graph.time_idx)
    states = _noised_states(gt.states, rng, cfg, device)
    gaps = np.concatenate([np.diff(graph.time_idx), [0]]).astype(np.float64)
    cum_rot = factors.cumulative_rotations(
        torch.as_tensor(gt.omega_full, dtype=torch.float64, device=device),
        1.0, torch.as_tensor(graph.time_idx, device=device)).cpu().numpy()
    solver = ba.SolverParams(num_hops=int(np.ceil(gaps.max() / 100.0)) + 1)
    n_pad = window.bucket(N, cfg.knot_bucket)
    m_pad = window.bucket(len(graph.ii), cfg.obs_bucket, cfg.obs_bucket)
    st0, prob = window._pad_problem(
        states, gaps, cum_rot, gt.landmarks_xyz, graph.uv, graph.conf,
        graph.ii, n_pad, m_pad, device, dtype)
    out, _, _, _ = window._solve_window(st0, prob, cfg.lambda_init,
                                        init_iters, num_iters, solver,
                                        sched_offset=-init_iters)
    return out[:N].cpu().numpy(), graph.time_idx, gt.states


class _Constellation(NamedTuple):
    """B orbits padded to one bucket, ready for solve_window_batch."""

    seeds: List[int]  # the orbits kept, in order
    states0: torch.Tensor  # (B, n_pad, 10) noised initial states
    prob: ba.BAProblem  # leading B on every field but intrinsics
    lamda: torch.Tensor  # (B,)
    params: ba.SolverParams
    gt_states: List[np.ndarray]  # (N_b, 10) ground-truth knot states


def _prepare_constellation(seeds: Sequence[int], seqs, duration_s: int,
                           cfg: StreamingConfig, knot_pad: Optional[int],
                           obs_pad: Optional[int],
                           device) -> Optional[_Constellation]:
    """The constellation's batch from one sequence per seed (any form
    `stream_inputs` takes): graph, GT, gate and compaction per orbit, an
    orbit without detections or with < 2 knots left skipped; the initial
    noise drawn from ONE numpy Generator seeded 0, orbit after orbit
    (position, attitude, velocity, as the JAX package draws them, so a
    skipped orbit draws nothing); then the common n_pad / m_pad buckets,
    the padded problems stacked, and SolverParams with the hops of the
    longest gap.  Conditioning runs in f64 and the batch is padded (so
    solved) in cfg.dtype.  None when no orbit is left."""
    window._check_supported(cfg)
    device = resolve_device(device)
    dtype = window._DTYPES[cfg.dtype]

    def t(a, dt=torch.float64):
        return torch.tensor(np.asarray(a), dtype=dt, device=device)

    rng = np.random.default_rng(0)
    kept, valid = [], []
    for s, seq in zip(seeds, seqs):
        det_rows, orbit = stream_inputs(seq)
        if len(det_rows) == 0:
            continue
        graph, gt = _gated(det_rows, orbit, duration_s, device)
        N = len(graph.time_idx)
        if N < 2 or len(graph.ii) == 0:
            continue
        states = _noised_states(gt.states, rng, cfg, device)
        gaps = np.concatenate([np.diff(graph.time_idx), [0]]).astype(
            np.float64)
        cum = factors.cumulative_rotations(
            t(gt.omega_full), 1.0, t(graph.time_idx, torch.int64)
        ).cpu().numpy()
        kept.append((states, gaps, cum, gt, graph))
        valid.append(s)
    if not kept:
        return None
    n_pad = knot_pad or max(window.bucket(p[0].shape[0], cfg.knot_bucket)
                            for p in kept)
    m_pad = obs_pad or max(window.bucket(len(p[4].ii), cfg.obs_bucket,
                                         cfg.obs_bucket) for p in kept)
    padded = [window._pad_problem(st, gaps, cum, gt.landmarks_xyz, graph.uv,
                                  graph.conf, graph.ii, n_pad, m_pad, device,
                                  dtype)
              for st, gaps, cum, gt, graph in kept]
    max_gap = max(float(p[1].max()) for p in kept)
    return _Constellation(
        valid, torch.stack([p[0] for p in padded]),
        ba.stack_problems([p[1] for p in padded]),
        torch.full((len(kept),), cfg.lambda_init, dtype=dtype, device=device),
        ba.SolverParams(num_hops=int(np.ceil(max_gap / 100.0)) + 1),
        [p[3].states for p in kept])


def constellation_from_sequences(seeds: Sequence[int], seqs,
                                 duration_s: int = 3600, num_iters: int = 20,
                                 init_iters: int = 10,
                                 cfg: StreamingConfig = StreamingConfig(),
                                 knot_pad: Optional[int] = None,
                                 obs_pad: Optional[int] = None,
                                 device=DEFAULT_DEVICE) -> dict:
    """run_constellation after its simulation: the sequences of `seeds`
    (one each, in order) prepared, solved by one solve_window_batch call
    (init_iters vision-only, schedule offset -init_iters; its wall taken
    with the device synchronised on both sides) and scored."""
    batch = _prepare_constellation(seeds, seqs, duration_s, cfg, knot_pad,
                                   obs_pad, device)
    if batch is None:
        return {"num_orbits": 0}
    sync = (torch.cuda.synchronize if batch.states0.is_cuda
            else (lambda: None))
    sync()
    t0 = time.time()
    out_b, _, _, _ = window.solve_window_batch(
        batch.states0, batch.prob, batch.lamda, init_iters, num_iters,
        batch.params, sched_offset=-init_iters)
    sync()
    wall = time.time() - t0
    out = out_b.cpu().numpy()
    B = len(batch.seeds)
    return {
        "num_orbits": B,
        "orbit_seeds": batch.seeds,
        "median_errors_km": [float(np.median(np.linalg.norm(
            out[i, :len(gt), :3] - gt[:, :3], axis=-1)))
            for i, gt in enumerate(batch.gt_states)],
        "wall_s": wall,
        "orbit_frames_per_s": B * duration_s / wall,
    }


def run_constellation(seeds: List[int], duration_s: int = 3600,
                      num_iters: int = 20, init_iters: int = 10,
                      cfg: StreamingConfig = StreamingConfig(),
                      along_track: bool = True,
                      knot_pad: Optional[int] = None,
                      obs_pad: Optional[int] = None,
                      device=DEFAULT_DEVICE) -> dict:
    """Constellation batch orbit determination (BASELINE config 4, "8
    orbits jit-vmapped, per-chip BA"): each seed simulated
    (frame_stride 5), the orbits padded to one common bucket and solved by
    ONE solve_window_batch call, whose every LM iteration runs all orbits
    at once.  Returns {"num_orbits", "orbit_seeds", "median_errors_km",
    "wall_s" (the synchronised solve), "orbit_frames_per_s"}, or
    {"num_orbits": 0} when no orbit is solvable."""
    seqs = [simulate_sequence(s, duration_s, along_track=along_track,
                              frame_stride=5, device=device) for s in seeds]
    return constellation_from_sequences(seeds, seqs, duration_s, num_iters,
                                        init_iters, cfg, knot_pad, obs_pad,
                                        device)
