"""Shared helpers of the JAX-vs-PyTorch parity tests (tests/test_torch_*.py).

Every input is made from a seed with numpy (or by the JAX package in f64 on
the CPU) and handed to both packages as numpy arrays.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vinsat_tpu.core import quat as jquat
from vinsat_tpu.estimation import ba as jba
from vinsat_tpu.estimation import factors as jfactors
from vinsat_tpu.sim import orbits

INTR = np.array([3547.8512126219637, 3547.8512126219637, 2304.0, 1296.0])


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
