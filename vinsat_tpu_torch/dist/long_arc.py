"""Long-arc arc-sharded OD (BASELINE.json config 5(a); port of
vinsat_tpu/dist/long_arc.py): a whole orbit arc whose knots are split over
the arc shards, solved by iterating the sharded LM step.

The host prepares the per-knot-budget ShardedProblem from a simulated
sequence; every LM iteration runs on the problem's device (halo
exchanges, kernel K2's normal-equation assembly, the SPIKE solve).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from vinsat_tpu_torch.config import (DEFAULT_DEVICE, REFERENCE_INTRINSICS,
                                     resolve_device)
from vinsat_tpu_torch.core import quat
from vinsat_tpu_torch.dist import mesh as mesh_mod
from vinsat_tpu_torch.dist import sharded_ba
from vinsat_tpu_torch.estimation import ba, factors, ingest
from vinsat_tpu_torch.pipeline import stream_inputs


class LongArcResult(NamedTuple):
    states: np.ndarray  # (N, 10)
    errors_km: np.ndarray  # (N,) final per-knot position errors
    knot_times: np.ndarray


def build_sharded_problem(seq, n_arc: int, max_dets_per_knot: int = 4,
                          noise_pos_km: float = 100.0,
                          noise_ori_rad: float = 0.2,
                          noise_vel_rel: float = 0.1,
                          dtype=torch.float64, seed: int = 0,
                          device=DEFAULT_DEVICE):
    """Simulated sequence (or any form `pipeline.stream_inputs` takes) ->
    (ShardedProblem (1, n_arc, N / n_arc, ...) on `device`, gt_states,
    knot_times, n_real).  Initial (noised) states live in prob.states.

    Knots are padded to a multiple of n_arc; observations are re-bucketed to
    a fixed per-knot budget.  The noise comes from
    np.random.default_rng(seed), as in the JAX package."""
    device = resolve_device(device)
    det_rows, orbit = stream_inputs(seq)
    rng = np.random.default_rng(seed)
    T = orbit.shape[0]
    graph = ingest.build_graph(det_rows, T)
    gt = ingest.process_ground_truths(orbit, graph, device=device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device)

    intr = np.array(REFERENCE_INTRINSICS)
    uv_proj = factors.project_landmarks(
        t(gt.states), t(gt.landmarks_xyz),
        torch.as_tensor(graph.ii, device=device), t(intr)).cpu().numpy()
    graph, gt, _ = ingest.gate_and_compact(graph, gt, uv_proj)
    N0 = len(graph.time_idx)
    N = ((N0 + n_arc - 1) // n_arc) * n_arc
    D = max_dets_per_knot

    # re-bucket ragged obs into per-knot slots
    lm_xyz = np.zeros((N, D, 3))
    uv = np.zeros((N, D, 2))
    conf = np.zeros((N, D))
    ov = np.zeros((N, D))
    fill = np.zeros(N, dtype=int)
    for j, k in enumerate(graph.ii):
        s = fill[k]
        if s >= D:
            continue
        lm_xyz[k, s] = gt.landmarks_xyz[j]
        uv[k, s] = graph.uv[j]
        conf[k, s] = graph.conf[j]
        ov[k, s] = 1.0
        fill[k] += 1

    gaps = np.zeros(N)
    gaps[:N0 - 1] = np.diff(graph.time_idx)
    cum = np.zeros((N, 4))
    cum[:, 3] = 1.0
    cum[:N0] = factors.cumulative_rotations(
        t(gt.omega_full), 1.0,
        torch.as_tensor(graph.time_idx, device=device)).cpu().numpy()
    pv = np.zeros(N)
    pv[:N0 - 1] = 1.0

    pos0 = gt.states[:, :3] + rng.standard_normal((N0, 3)) * noise_pos_km
    phi = quat.log(t(gt.states[:, 3:7])).cpu().numpy()
    phi = phi + rng.standard_normal((N0, 3)) * noise_ori_rad
    q0 = quat.exp(t(phi)).cpu().numpy()
    vs = np.abs(gt.states[:, 7:10]).mean()
    vel0 = gt.states[:, 7:10] + rng.standard_normal((N0, 3)) * vs * noise_vel_rel
    st = np.zeros((N, 10))
    st[:, 6] = 1.0
    st[:N0] = np.concatenate([pos0, q0, vel0], axis=1)

    fields = dict(states=st, gaps=gaps, cum_rot=cum, lm_xyz=lm_xyz, uv=uv,
                  conf=conf, obs_valid=ov, pair_valid=pv)
    fields = {k: v[None] for k, v in fields.items()}
    fields["intrinsics"] = intr
    prob = sharded_ba.sharded_problem_from_numpy(fields, n_arc, device, dtype)
    return prob, gt.states, graph.time_idx, N0


def solve_long_arc(mesh: mesh_mod.Mesh, prob: sharded_ba.ShardedProblem,
                   gt_states, knot_t, n_real: int, num_iters: int = 20,
                   init_iters: int = 10,
                   params: Optional[ba.SolverParams] = None) -> LongArcResult:
    """Iterate the sharded LM step over one long arc (on the mesh's
    device)."""
    if params is None:
        max_gap = float(prob.gaps.max())
        params = ba.SolverParams(
            num_hops=int(np.ceil(max_gap / 100.0)) + 1)
    step = sharded_ba.make_sharded_ba_step(mesh, params)
    lam = torch.full((prob.states.shape[0],), 1e-4, dtype=prob.states.dtype,
                     device=prob.states.device)
    states = prob.states
    for i in range(num_iters):
        states, lam = step(i, lam, prob._replace(states=states),
                           initialize=float(i < init_iters))
    out = states[0].reshape(-1, 10).cpu().numpy()[:n_real]
    errs = np.linalg.norm(out[:, :3] - gt_states[:n_real, :3], axis=-1)
    return LongArcResult(out, errs, knot_t)
