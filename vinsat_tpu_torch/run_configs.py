"""BASELINE configurations 1-5 through the port (the runners of
configs/run_configs.py, which drives the JAX package):

  1 `run_ekf`            one simulated orbit, known landmarks, EKF-only OD;
  2 `run_fullbatch`      the same orbit, full-batch BA (40 LM iterations);
  3 `run_streaming`      a gapped orbit, detections matched to the DB
                         (`nearest_landmark`), streamed BA-only and EKF+BA
                         hybrid, beside the EKF alone on it and on a
                         1500 s-gap arc;
  4 `run_constellation`  8 orbits (seeds 0-7) solved as one batch;
  5 `run_longarc`        (a) the same orbit as 1 solved whole over 8 arc
                         shards, and (b) a gapped orbit streamed with each
                         window over the arc shards (`dist_stream`).

Each returns the dict the JAX runner prints, unrounded.  Each takes the
sequences it runs on (the port's SimulatedSequence, or a mapping with
det_rows, orbit_pos_eci_km and, for config 3, db_lon / db_lat: JAX's rows
from a fixture) or else simulates them with the port's own generator at
the runner's duration.  Configs 2, 4 and 5 take a `dtype`; `main()`
picks it from the device as the JAX runner does (x64 is on only on the
CPU): f32 on the card, f64 on the CPU, with the conditioning in f64
either way.  Walls are host clocks around a run that ends synchronised.
Config 6 (the reference's real landmark DB) is not run here.

    python -m vinsat_tpu_torch.run_configs 1|2|3|4|5|all [--duration S]
        [--device DEV]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Mapping, Optional

import numpy as np
import torch

from vinsat_tpu_torch import pipeline
from vinsat_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from vinsat_tpu_torch.dist import long_arc
from vinsat_tpu_torch.dist import mesh as mesh_mod
from vinsat_tpu_torch.dist import stream as dist_stream
from vinsat_tpu_torch.estimation import ekf, factors, ingest
from vinsat_tpu_torch.estimation.hybrid import build_knot_obs_buffers
from vinsat_tpu_torch.estimation.window import _DTYPES, StreamingConfig
from vinsat_tpu_torch.evalx import ate
from vinsat_tpu_torch.kernels.matching import nearest_landmark

# the JAX runner's EKF intrinsics (its own focal length, not the camera's)
EKF_INTRINSICS = (3547.8512126219637, 3547.8512126219637, 2304.0, 1296.0)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def config_sequence(duration: int, device=DEFAULT_DEVICE, **kw):
    """The runners' orbit: port seed 1, frame_stride 5, along track."""
    return pipeline.simulate_sequence(1, duration_s=duration, frame_stride=5,
                                      along_track=True, device=device, **kw)


def ekf_errors(seq, orbit_len: int, device):
    """EKF-only pass over a sequence's (ungated) detection graph, from GT
    knot 0 offset by (30, -20, 10) km: (position errors (N,), knots, wall
    s)."""
    det_rows, orbit = pipeline.stream_inputs(seq)
    graph = ingest.build_graph(det_rows, orbit_len)
    gt = ingest.process_ground_truths(orbit, graph, device=device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device)

    N = len(graph.time_idx)
    lm, uv, ov = build_knot_obs_buffers(graph, gt, 0, N, max_obs=8)
    gaps = np.concatenate([[0.0], np.diff(graph.time_idx)]).astype(float)
    cum = factors.cumulative_rotations(
        t(gt.omega_full), 1.0,
        torch.as_tensor(graph.time_idx, device=device)).cpu().numpy()
    cum_before = np.concatenate([[[0, 0, 0, 1.0]], cum[:-1]], axis=0)
    x0 = gt.states[0].copy()
    x0[:3] += np.array([30.0, -20.0, 10.0])
    cov0 = np.diag([1e3] * 3 + [1e-2] * 3 + [1e-1] * 3)
    cfg = ekf.EKFConfig(num_hops=int(np.ceil(max(gaps.max(), 1) / 100)) + 1)
    _sync(device)
    t0 = time.time()
    states, _ = ekf.run_filter(t(x0), t(cov0), t(gaps), t(cum_before), t(lm),
                               t(uv), t(ov), t(EKF_INTRINSICS), cfg)
    _sync(device)
    wall = time.time() - t0
    err = np.linalg.norm(states.cpu().numpy()[:, :3] - gt.states[:, :3],
                         axis=-1)
    return err, N, wall


def run_ekf(duration: int = 3600, seq=None, device=DEFAULT_DEVICE) -> dict:
    """Config 1: EKF-only OD of the along-track orbit."""
    device = resolve_device(device)
    seq = config_sequence(duration, device) if seq is None else seq
    err, N, wall = ekf_errors(seq, duration, device)
    return {"config": "1-ekf", "final_error_km": float(err[-1]),
            "median_error_km": float(np.median(err)), "knots": N,
            "wall_s": wall}


def run_fullbatch(duration: int = 3600, seq=None, dtype: str = "float64",
                  device=DEFAULT_DEVICE) -> dict:
    """Config 2: full-batch BA of the same orbit, 40 LM iterations."""
    device = resolve_device(device)
    seq = config_sequence(duration, device) if seq is None else seq
    _sync(device)
    t0 = time.time()
    states, knot_t, gt_states = pipeline.run_full_batch(
        seq, seed=1, num_iters=40, cfg=StreamingConfig(dtype=dtype),
        device=device)
    wall = time.time() - t0
    err = np.linalg.norm(states[:, :3] - gt_states[:, :3], axis=-1)
    return {"config": "2-fullbatch", "median_error_km": float(np.median(err)),
            "knots": len(knot_t), "wall_s": wall}


def _ekf_only_errors(seq, device) -> dict:
    """The filter half of the hybrid alone over the same detection graph
    (config 3's delta report)."""
    orbit = pipeline.stream_inputs(seq)[1]
    err, _, _ = ekf_errors(seq, orbit.shape[0] - 1, device)
    return {"final_error_km": float(err[-1]),
            "median_error_km": float(np.median(err))}


def _db_lonlat(seq):
    if isinstance(seq, Mapping) or hasattr(seq, "files"):
        return np.asarray(seq["db_lon"]), np.asarray(seq["db_lat"])
    return seq.db.lon.cpu().numpy(), seq.db.lat.cpu().numpy()


def run_streaming(duration: int = 3600, seq=None, seq_gap=None,
                  device=DEFAULT_DEVICE) -> dict:
    """Config 3: the gapped orbit (passes every max(900, duration // 2)
    s, 240 s long), every detection re-associated with its nearest DB
    landmark, streamed BA-only and as the EKF+BA hybrid, with the EKF
    alone on it and on `seq_gap` (passes every 1800 s, 300 s long, so
    1500 s gaps; simulated when not given)."""
    device = resolve_device(device)
    if seq is None:
        seq = config_sequence(duration, device,
                              pass_every_s=max(900, duration // 2),
                              pass_len_s=240)
    det_rows, orbit = pipeline.stream_inputs(seq)
    lon, lat = _db_lonlat(seq)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device)

    idx, d2 = nearest_landmark(t(det_rows[:, 1:3]), t(lon), t(lat))
    idx = idx.cpu().numpy()
    rows = det_rows.copy()
    rows[:, 1] = lon[idx]
    rows[:, 2] = lat[idx]

    out = {}
    for tag, cfg in [("ba_only", StreamingConfig()),
                     ("hybrid", StreamingConfig(use_ekf_hybrid=True))]:
        _sync(device)
        t0 = time.time()
        res = pipeline.run_streaming((rows, orbit), seed=1, cfg=cfg,
                                     device=device)
        wall = time.time() - t0
        out[tag] = {
            "final_error_km": float(res.errors[-1]),
            "min_error_km": float(res.errors.min()),
            "time_to_5km_s": ate.time_to_threshold(res.errors, res.times,
                                                   5.0),
            "wall_s": wall,
        }
    out["ekf_only"] = _ekf_only_errors((rows, orbit), device)
    if seq_gap is None:
        seq_gap = config_sequence(max(3600, duration), device,
                                  pass_every_s=1800, pass_len_s=300)
    out["ekf_only_long_gap"] = dict(_ekf_only_errors(seq_gap, device),
                                    max_gap_s=1500,
                                    duration_s=max(3600, duration))
    gaps = np.diff(np.unique(rows[:, 0]))
    return {"config": "3-streaming",
            "matcher_max_d2": float(d2.max()),
            "max_gap_s": int(gaps.max()) if len(gaps) else 0, **out}


def run_constellation(duration: int = 3600, seqs=None,
                      dtype: str = "float64", device=DEFAULT_DEVICE) -> dict:
    """Config 4: orbit seeds 0-7 (along track, frame_stride 5) solved as
    one batch, 20 LM iterations (10 vision-only).  `seqs`: the 8
    sequences in seed order, else simulated."""
    device = resolve_device(device)
    seeds = list(range(8))
    cfg = StreamingConfig(dtype=dtype)
    if seqs is None:
        out = pipeline.run_constellation(seeds, duration_s=duration,
                                         num_iters=20, cfg=cfg, device=device)
    else:
        out = pipeline.constellation_from_sequences(
            seeds, seqs, duration, num_iters=20, cfg=cfg, device=device)
    return {"config": "4-constellation", **out}


def run_longarc(duration: int = 3600, seq=None, seq_gap=None,
                dtype: str = "float64", device=DEFAULT_DEVICE) -> dict:
    """Config 5 over 8 arc shards: (a) the along-track orbit (`seq`) solved
    whole, 20 LM iterations (8 vision-only), initial noise 50 km; (b) the
    gapped orbit (`seq_gap`: passes every max(900, duration // 2) s, 240 s
    long) streamed by `stream_orbit_sharded` (max_iters 30, seed 1)."""
    device = resolve_device(device)
    n_arc = 8
    mesh = mesh_mod.make_mesh(1, n_arc, device=device)
    seq = config_sequence(duration, device) if seq is None else seq
    prob, gt_states, knot_t, n_real = long_arc.build_sharded_problem(
        seq, n_arc=n_arc, dtype=_DTYPES[dtype], noise_pos_km=50.0,
        device=device)
    _sync(device)
    t0 = time.time()
    res = long_arc.solve_long_arc(mesh, prob, gt_states, knot_t, n_real,
                                  num_iters=20, init_iters=8)
    wall = time.time() - t0

    if seq_gap is None:
        seq_gap = config_sequence(duration, device,
                                  pass_every_s=max(900, duration // 2),
                                  pass_len_s=240)
    det_rows, orbit = pipeline.stream_inputs(seq_gap)
    _sync(device)
    t0 = time.time()
    res_s = dist_stream.stream_orbit_sharded(
        det_rows, orbit, mesh, seed=1,
        cfg=StreamingConfig(dtype=dtype, max_iters=30))
    wall_s = time.time() - t0
    return {"config": "5-longarc", "shards": n_arc, "knots": n_real,
            "median_error_km": float(np.median(res.errors_km)),
            "wall_s": wall,
            "dist_stream": {"final_error_km": float(res_s.errors[-1]),
                            "min_error_km": float(res_s.errors.min()),
                            "wall_s": wall_s}}


RUNNERS = {"1": run_ekf, "2": run_fullbatch, "3": run_streaming,
           "4": run_constellation, "5": run_longarc}


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", choices=list(RUNNERS) + ["all"])
    ap.add_argument("--duration", type=int, default=3600)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    # the JAX runner's x64 rule: configs 2, 4 and 5 solve in f32 on an
    # accelerator and in f64 on the CPU
    dtype = "float64" if device.type == "cpu" else "float32"
    for k in (list(RUNNERS) if args.which == "all" else [args.which]):
        kw = {"dtype": dtype} if k in ("2", "4", "5") else {}
        print(json.dumps(RUNNERS[k](args.duration, device=device, **kw)))


if __name__ == "__main__":
    main()
