"""End-to-end entry points of the port (vinsat_tpu/pipeline.py):
`simulate_sequence` (the detection simulator), `run_streaming`
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
`simulate_from_draws` is its deterministic core, which the parity tests
feed with the JAX package's own draws.
"""
from __future__ import annotations

import time
from typing import List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from vinsat_tpu_torch.config import (DEFAULT_DEVICE, REFERENCE_INTRINSICS,
                                     resolve_device)
from vinsat_tpu_torch.core import frames, quat
from vinsat_tpu_torch.estimation import ba, factors, ingest, window
from vinsat_tpu_torch.estimation.window import (StreamingConfig,
                                                StreamingResult, stream_orbit)
from vinsat_tpu_torch.evalx import ate, crlb
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
