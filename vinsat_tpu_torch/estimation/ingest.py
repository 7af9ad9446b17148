"""Host-side measurement ingest: detection rows -> factor-graph arrays
(port of vinsat_tpu/estimation/ingest.py).

`build_graph` is the JAX module's numpy path (its C++ fast path waits),
`gate_and_compact` and `split_windows` are copied as they are (the JAX
module cannot be imported without JAX), and `process_ground_truths` runs
its nadir quaternions, body rates and landmark lifts in torch on the
given device.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from vinsat_tpu_torch.core import frames, quat

KNOT_STRIDE = 1000  # s, filler-knot spacing


class DetectionGraph(NamedTuple):
    frame: np.ndarray  # (M,) detection frame index (1 Hz)
    uv: np.ndarray  # (M, 2)
    lonlat: np.ndarray  # (M, 2) lon, lat degrees
    conf: np.ndarray  # (M,)
    time_idx: np.ndarray  # (N,) knot times (frames), includes filler knots
    ii: np.ndarray  # (M,) obs -> knot index


def build_graph(det_rows: np.ndarray, orbit_len: int,
                knot_stride: int = KNOT_STRIDE) -> DetectionGraph:
    """Rows [frame, lon, lat, xc, yc, conf] -> graph: knots at unique
    detection frames plus filler knots every `knot_stride` frames between
    and after detections, out to the orbit length."""
    det_rows = np.asarray(det_rows, dtype=np.float64)
    if det_rows.size == 0:
        det_rows = det_rows.reshape(0, 6)
    order = np.argsort(det_rows[:, 0], kind="stable")
    det_rows = det_rows[order]
    frame = det_rows[:, 0]
    uv = det_rows[:, 3:5]
    lonlat = det_rows[:, 1:3]
    conf = det_rows[:, 5]
    if len(frame) == 0:
        return DetectionGraph(frame=frame, uv=uv, lonlat=lonlat, conf=conf,
                              time_idx=np.zeros(0, np.int64),
                              ii=np.zeros(0, np.int64))

    det_times = np.unique(frame).astype(np.int64)
    ii: List[int] = []
    time_idx_new: List[int] = []
    filler_idx = det_times.min() // knot_stride + 1
    filler_offset = 0
    # a detection knot always consumes its stride slot, so no duplicate
    # (zero-gap) knots are emitted
    for i, t in enumerate(det_times):
        while filler_idx * knot_stride < t:
            time_idx_new.append(filler_idx * knot_stride)
            filler_idx += 1
            filler_offset += 1
        if filler_idx * knot_stride == t:
            filler_idx += 1
        time_idx_new.append(int(t))
        num_points = int((frame == t).sum())
        ii.extend([i + filler_offset] * num_points)
    if det_times[-1] < orbit_len:
        while (filler_idx * knot_stride
               < (orbit_len // knot_stride) * knot_stride + 1):
            time_idx_new.append(filler_idx * knot_stride)
            filler_idx += 1
    return DetectionGraph(
        frame=frame, uv=uv, lonlat=lonlat, conf=conf,
        time_idx=np.array(time_idx_new, dtype=np.int64),
        ii=np.array(ii, dtype=np.int64),
    )


class GroundTruth(NamedTuple):
    pos_eci: np.ndarray  # (N, 3) km at knots
    vel_eci: np.ndarray  # (N, 3) km/s at knots (finite-difference)
    quat_eci: np.ndarray  # (N, 4) nadir quaternions at knots
    pos_eci_full: np.ndarray  # (T, 3)
    quat_eci_full: np.ndarray  # (T, 4)
    omega_full: np.ndarray  # (T, 3) body rates from quat sequence
    landmarks_xyz: np.ndarray  # (M, 3) km ECI
    states: np.ndarray  # (N, 10) GT knot states [pos, quat, vel]


def process_ground_truths(orbit_pos_eci_km: np.ndarray, graph: DetectionGraph,
                          dt: float = 1.0, device="cpu",
                          dtype=torch.float64) -> GroundTruth:
    """GT conditioning: forward-difference velocities, nadir attitude from
    position, body rates from the quaternion sequence, landmarks lifted
    lon/lat -> ECI at their frame time.  The torch work runs on `device`;
    results come back as host numpy arrays."""
    vel_full = np.diff(orbit_pos_eci_km, axis=0) / dt
    vel_full = np.concatenate([vel_full, np.zeros((1, 3))], axis=0)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    q_full_t = frames.nadir_quaternion(t(orbit_pos_eci_km))
    omega_full = quat.omega_from_sequence(q_full_t, dt).cpu().numpy()
    quat_full = q_full_t.cpu().numpy()
    lm_xyz = frames.lonlat_to_eci(t(graph.lonlat[:, 0]), t(graph.lonlat[:, 1]),
                                  t(graph.frame)).cpu().numpy()
    ti = graph.time_idx
    pos = orbit_pos_eci_km[ti]
    vel = vel_full[ti]
    q = quat_full[ti]
    states = np.concatenate([pos, q, vel], axis=1)
    return GroundTruth(pos, vel, q, orbit_pos_eci_km, quat_full, omega_full,
                       lm_xyz, states)


def gate_and_compact(graph: DetectionGraph, gt: GroundTruth,
                     uv_proj: np.ndarray,
                     u_max: float = 4700.0, v_max: float = 2600.0,
                     max_err: float = 1000.0, min_conf: float = 0.8,
                     knot_stride: int = KNOT_STRIDE
                     ) -> Tuple[DetectionGraph, GroundTruth, np.ndarray]:
    """Outlier gating + graph compaction.  Keeps observations passing the
    gate and knots that keep >= 1 observation or sit on the filler stride;
    re-indexes ii."""
    err = np.linalg.norm(uv_proj - graph.uv, axis=-1)
    mask = (
        (uv_proj[:, 0] > 0) & (uv_proj[:, 1] > 0)
        & (uv_proj[:, 0] < u_max) & (uv_proj[:, 1] < v_max)
        & (err < max_err) & (graph.conf > min_conf)
    )
    ii_kept = graph.ii[mask]
    N = graph.time_idx.shape[0]
    has_obs = np.zeros(N, dtype=bool)
    has_obs[np.unique(ii_kept)] = True
    keep_knot = has_obs | (graph.time_idx % knot_stride == 0)
    new_index = np.cumsum(keep_knot) - 1
    ii_new = new_index[ii_kept]

    graph2 = DetectionGraph(
        frame=graph.frame[mask],
        uv=graph.uv[mask],
        lonlat=graph.lonlat[mask],
        conf=graph.conf[mask],
        time_idx=graph.time_idx[keep_knot],
        ii=ii_new,
    )
    gt2 = GroundTruth(
        pos_eci=gt.pos_eci[keep_knot],
        vel_eci=gt.vel_eci[keep_knot],
        quat_eci=gt.quat_eci[keep_knot],
        pos_eci_full=gt.pos_eci_full,
        quat_eci_full=gt.quat_eci_full,
        omega_full=gt.omega_full,
        landmarks_xyz=gt.landmarks_xyz[mask],
        states=gt.states[keep_knot],
    )
    return graph2, gt2, mask


def split_windows(ii: np.ndarray, time_idx: np.ndarray,
                  contiguous_gap: int = 100, split_gap: int = 200,
                  min_contiguous: int = 4) -> List[Tuple[int, int, bool]]:
    """Sequence of (t_final, i_final, seq_end) window ends: split at a
    detection gap > split_gap after > min_contiguous contiguous detections;
    the counter resets at each window start."""
    out = []
    i = 0
    while True:
        contiguous = 0
        found = False
        for j in range(i + 1, len(ii)):
            gap = time_idx[ii[j]] - time_idx[ii[j - 1]]
            if gap < contiguous_gap:
                contiguous += 1
            if gap > split_gap and contiguous > min_contiguous:
                out.append((int(ii[j - 1] + 1), int(j), False))
                i = j
                found = True
                break
        if not found:
            out.append((int(ii[-1] + 1), int(len(ii)), True))
            return out
