"""Shared helpers of the JAX-vs-PyTorch parity tests (tests/test_torch_*.py).

Every input is made from a seed with numpy (or by the JAX package in f64 on
the CPU) and handed to both packages as numpy arrays.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vinsat_tpu import pipeline as jpipeline
from vinsat_tpu.core import quat as jquat
from vinsat_tpu.estimation import ba as jba
from vinsat_tpu.estimation import factors as jfactors
from vinsat_tpu.sim import camera as jcam
from vinsat_tpu.sim import detections as jdet
from vinsat_tpu.sim import landmarks as jlm
from vinsat_tpu.sim import mgrs as jmgrs
from vinsat_tpu.sim import orbits

INTR = np.array([3547.8512126219637, 3547.8512126219637, 2304.0, 1296.0])


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """One torch CPU thread for a module that imports this fixture, its
    previous count restored after: the port's eager CPU work is many small
    ops, which one thread runs faster than several, and the test workers
    run side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a, dtype=torch.float64):
    """numpy / JAX array -> CPU torch tensor (int arrays -> int64)."""
    a = np.array(a)
    if a.dtype.kind in "iu":
        return torch.as_tensor(a, dtype=torch.int64)
    return torch.as_tensor(a, dtype=dtype)


def rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def random_states(rng, n: int) -> np.ndarray:
    """(n, 10) LEO-like knot states [pos, unit quat, vel]."""
    pos = rng.normal(size=(n, 3)) * 300.0 + np.array([6900.0, 0.0, 0.0])
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    vel = rng.normal(size=(n, 3)) * 0.1 + np.array([0.0, 7.5, 0.0])
    return np.concatenate([pos, q, vel], axis=1)


@functools.lru_cache(maxsize=1)
def _trajectory():
    """One simulated 3600 s orbit per process (its rollout compiles once)."""
    return orbits.generate_trajectory(jax.random.PRNGKey(7), duration_s=3600)


def orbit_problem(rng, n_knots: int = 8, obs_per_knot: int = 6,
                  gap: float = 150.0, noise_px: float = 1.0):
    """A BA problem along a simulated orbit (tests/test_ba.py's recipe;
    knots every `gap` s within the first hour):
    returns (gt_states (N, 10), fields) as numpy, fields named as the
    BAProblem's (unpadded, every entry valid)."""
    traj = _trajectory()
    t_idx = (np.arange(n_knots) * gap).astype(int)
    pos = np.asarray(traj.pos_eci)[t_idx]
    q = np.asarray(traj.quat_nadir_eci)[t_idx]
    vel = np.asarray(traj.vel_eci)[t_idx]
    states = np.concatenate([pos, q, vel], axis=1)
    lms, ii = [], []
    for k in range(n_knots):
        ground = pos[k] * (6378.0 / np.linalg.norm(pos[k]))
        for _ in range(obs_per_knot):
            lms.append(ground + rng.normal(size=3) * 30.0)
            ii.append(k)
    lm = np.stack(lms)
    ii = np.array(ii, np.int32)
    uv = np.asarray(jfactors.project_landmarks(
        jnp.asarray(states), jnp.asarray(lm), jnp.asarray(ii),
        jnp.asarray(INTR)))
    uv = uv + noise_px * rng.normal(size=uv.shape)
    omega = jquat.omega_from_sequence(traj.quat_nadir_eci, 1.0)
    cum_rot = np.asarray(jfactors.cumulative_rotations(
        omega, 1.0, jnp.asarray(t_idx)))
    gaps = np.array([gap] * (n_knots - 1) + [0.0])
    return states, dict(gaps=gaps, cum_rot=cum_rot, landmarks_xyz=lm,
                        landmarks_uv=uv, conf=rng.uniform(0.85, 1.0, len(ii)),
                        ii=ii)


def perturb(rng, states: np.ndarray, pos_km: float = 5.0,
            rot_rad: float = 0.01) -> np.ndarray:
    """GT states + position / attitude noise (numpy, via the JAX quat)."""
    n = states.shape[0]
    out = states.copy()
    out[:, :3] += rng.normal(size=(n, 3)) * pos_km
    out[:, 3:7] = np.asarray(jquat.box_plus(
        jnp.asarray(states[:, 3:7]), jnp.asarray(rng.normal(size=(n, 3))
                                                 * rot_rad)))
    return out


def jax_problem(fields: dict) -> jba.BAProblem:
    """JAX BAProblem from numpy fields (int32 ii)."""
    return jba.BAProblem(**{
        k: jnp.asarray(np.asarray(v, np.int32) if k == "ii" else v)
        for k, v in fields.items()})


def numpy_fields(prob) -> dict:
    """A JAX BAProblem's fields as numpy arrays."""
    return {k: np.asarray(v) for k, v in prob._asdict().items()}


def jax_trajectory_draws(key):
    """The draws of the JAX `orbits.generate_trajectory(key)` (f64): the
    elements (6,) in OrbitalElements order, the unit quaternion q0 (4,)
    and the body rates w0 (3,), by repeating its key splits."""
    k_att, k_oe = jax.random.split(key)
    oe = orbits.sample_random_oe(k_oe)
    kq, kw = jax.random.split(k_att)
    q0 = jax.random.normal(kq, (4,), jnp.float64)
    q0 = np.asarray(q0 / jnp.linalg.norm(q0))
    w0 = 2 * (np.pi / 180) * np.asarray(jax.random.normal(kw, (3,),
                                                          jnp.float64))
    return np.array([float(v) for v in oe]), q0, w0


def jax_simulation(seed: int, db=None, **sim_kw) -> dict:
    """Run the JAX `simulate_sequence(seed, db=db, **sim_kw)` (f64, CPU) and
    recover every draw it made, by repeating its key splits:

      oe (6,), q0 (4,), w0 (3,) — the trajectory's draws;
      db_seed — the int its landmark DB was drawn from (-1 with `db`);
      score_frame, score_landmark, score — the selection score of every
        in-view pair of a gated frame (the only ones that can be chosen),
        row-major, frames counted in the strided frame list;
      noise (M, 2), conf (M,) — the standard-normal pixel noise and the
        uniform confidence draw of the M valid slots, row-major;

    beside its outputs: det_rows, pos_eci (T, 3), frame_visible and the
    per-frame visibility count (Tf,), and the DB, the trajectory and the
    FrameDetections as dicts of numpy arrays."""
    seq = jpipeline.simulate_sequence(seed, db=db, **sim_kw)
    along = sim_kw.get("along_track", False)
    stride = sim_kw.get("frame_stride", 1)
    max_dets = sim_kw.get("max_dets", 8)
    k_traj, k_db, k_det = jax.random.split(jax.random.PRNGKey(seed), 3)
    oe, q0, w0 = jax_trajectory_draws(k_traj)
    if db is not None:
        db_seed = -1
    elif along:
        db_seed = int(jax.random.randint(k_db, (), 0, 2**31 - 1))
    else:
        db_seed = int(np.asarray(jax.random.key_data(k_db)).ravel()[-1]
                      ) & 0x7FFFFFFF
    jdb = seq.db
    active = (jnp.ones(len(jmgrs.ZONE_LABELS), bool) if along and db is None
              else jmgrs.active_region_mask())
    cam = jcam.CameraModel.from_hfov()
    pos = jnp.asarray(np.asarray(seq.traj.pos_ecef)[::stride] * 1000.0)
    bounds, _ = jcam.footprint_bounds(cam, jcam.CameraPose.nadir(pos))
    count = np.asarray(jlm.visible_best_count(jdb, bounds, active))
    gate = jdet._frame_gate(cam, jdb, pos, active, 3)
    mask, _ = jax.vmap(lambda p, g: jdet._project_frame(
        cam, jdb, p, g, active))(pos, gate)
    mask = np.asarray(mask)
    fi, li = np.nonzero(mask)
    score = np.asarray(jax.random.uniform(k_det, mask.shape))[fi, li]
    dets = jdet.generate_detections(
        k_det, seq.traj, jdb, noise_px=sim_kw.get("noise_px", 4.0),
        max_dets=max_dets, conf_low=0.82, frame_stride=stride,
        region_mask=active if along and db is None else None)
    valid = np.asarray(dets.valid)
    k_noise, k_conf = jax.random.split(jax.random.fold_in(k_det, 1))
    noise = np.asarray(jax.random.normal(k_noise, valid.shape + (2,)))
    conf = np.asarray(jax.random.uniform(k_conf, valid.shape))
    return dict(
        oe=oe, q0=q0,
        w0=w0, db_seed=db_seed, score_frame=fi, score_landmark=li,
        score=score, noise=noise[valid], conf=conf[valid],
        det_rows=np.asarray(seq.det_rows), pos_eci=np.asarray(
            seq.orbit_pos_eci_km), frame_visible=np.asarray(gate),
        count=count, db={k: np.asarray(v) for k, v in jdb._asdict().items()},
        traj={k: np.asarray(v) for k, v in seq.traj._asdict().items()},
        dets={k: np.asarray(v) for k, v in dets._asdict().items()})
