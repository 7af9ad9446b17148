"""PyTorch port vs JAX: core/quat, core/frames, core/dynamics (f64, CPU).

Tolerance 1e-10 relative: both sides evaluate the same formulas in f64;
the differences are summation order and the RK4 step Jacobian's form
(closed-form variational step vs jax.jacfwd)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import T, random_states, rel_err
from vinsat_tpu.core import dynamics as jdyn
from vinsat_tpu.core import frames as jframes
from vinsat_tpu.core import quat as jquat
from vinsat_tpu_torch.core import dynamics, frames, quat

TOL = 1e-10


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _quat_cases(rng):
    q1, q2 = _unit_quats(rng, 16), _unit_quats(rng, 16)
    phi = rng.normal(size=(16, 3)) * 0.5
    phi[0] = 0.0
    phi[1] = 1e-8  # small-angle branch
    v = rng.normal(size=(16, 3)) * 100.0
    R = np.asarray(jquat.to_matrix(jnp.asarray(q1)))
    seq = np.asarray(jquat.normalize(jnp.asarray(np.cumsum(
        rng.normal(size=(20, 4)) * 0.01, axis=0) + np.array([0, 0, 0, 1.0]))))
    return {
        "multiply": ((q1, q2), (q1, q2)),
        "conjugate": ((q1,), (q1,)),
        "normalize": ((q1 * 3.0,), (q1 * 3.0,)),
        "exp": ((phi,), (phi,)),
        "log": ((q1,), (q1,)),
        "rotate": ((q1, v), (q1, v)),
        "rotate_inverse": ((q1, v), (q1, v)),
        "to_matrix": ((q1,), (q1,)),
        "from_matrix": ((R,), (R,)),
        "attitude_jacobian": ((q1,), (q1,)),
        "box_plus": ((q1, phi), (q1, phi)),
        "omega_from_sequence": ((seq, 1.0), (seq, 1.0)),
    }


@pytest.mark.parametrize("name", [
    "multiply", "conjugate", "normalize", "exp", "log", "rotate",
    "rotate_inverse", "to_matrix", "from_matrix", "attitude_jacobian",
    "box_plus", "omega_from_sequence"])
def test_quat_matches_jax(name):
    rng = np.random.default_rng(1)
    jargs, targs = _quat_cases(rng)[name]
    want = np.asarray(getattr(jquat, name)(
        *[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in jargs]))
    got = getattr(quat, name)(
        *[T(a) if isinstance(a, np.ndarray) else a for a in targs])
    assert rel_err(got, want) < TOL, name


def test_from_matrix_roundtrip():
    q = _unit_quats(np.random.default_rng(2), 32)
    got = quat.from_matrix(quat.to_matrix(T(q))).numpy()
    # q and -q are the same rotation
    err = np.minimum(np.abs(got - q).max(-1), np.abs(got + q).max(-1))
    assert err.max() < 1e-12


@pytest.mark.parametrize("name", [
    "gmst_rad", "rz_eci_to_ecef", "eci_to_ecef", "ecef_to_eci",
    "geodetic_to_ecef", "lonlat_to_eci", "nadir_rotation",
    "nadir_quaternion"])
def test_frames_match_jax(name):
    rng = np.random.default_rng(3)
    t = rng.uniform(0, 10800, 24)
    r = random_states(rng, 24)[:, :3]
    lat, lon = rng.uniform(-80, 80, 24), rng.uniform(-180, 180, 24)
    args = {
        "gmst_rad": (t,), "rz_eci_to_ecef": (t,), "eci_to_ecef": (r, t),
        "ecef_to_eci": (r, t), "geodetic_to_ecef": (lat, lon),
        "lonlat_to_eci": (lon, lat, t), "nadir_rotation": (r,),
        "nadir_quaternion": (r,),
    }[name]
    want = np.asarray(getattr(jframes, name)(*[jnp.asarray(a) for a in args]))
    got = getattr(frames, name)(*[T(a) for a in args])
    assert rel_err(got, want) < TOL, name


def _orbit_x(rng, n):
    s = random_states(rng, n)
    return np.concatenate([s[:, :3], s[:, 7:10]], axis=1)


@pytest.mark.parametrize("h", [1.0, 37.5, 100.0])
def test_rk4_step_matches_jax(h):
    x = _orbit_x(np.random.default_rng(4), 12)
    want = np.asarray(jdyn.rk4_step(jnp.asarray(x), h))
    assert rel_err(dynamics.rk4_step(T(x), h), want) < TOL


def test_rk4_step_jacobian_matches_jacfwd():
    rng = np.random.default_rng(5)
    x = _orbit_x(rng, 8)
    h = np.array([1.0, 5.0, 40.0, 100.0, 100.0, 0.0, 73.0, 100.0])
    want_x = np.asarray(jax.vmap(lambda a, b: jdyn.rk4_step(a, b))(
        jnp.asarray(x), jnp.asarray(h)))
    want_A = np.asarray(jax.vmap(jax.jacfwd(
        lambda a, b: jdyn.rk4_step(a, b)))(jnp.asarray(x), jnp.asarray(h)))
    got_x, got_A = dynamics.rk4_step_with_jacobian(T(x), T(h)[:, None])
    assert rel_err(got_x, want_x) < TOL
    assert rel_err(got_A, want_A) < TOL


def _gap_case(seed):
    rng = np.random.default_rng(seed)
    s = random_states(rng, 9)
    gaps = np.array([5.0, 100.0, 250.0, 0.0, 999.0, 1000.0, 35.0, 1.0, 0.0])
    return s[:, :3], s[:, 7:10], gaps


@pytest.mark.parametrize("num_hops", [11, 16])
def test_propagate_gaps_matches_jax(num_hops):
    pos, vel, gaps = _gap_case(6)
    wp, wv = jdyn.propagate_gaps(jnp.asarray(pos), jnp.asarray(vel),
                                 jnp.asarray(gaps), num_hops=num_hops)
    gp, gv = dynamics.propagate_gaps(T(pos), T(vel), T(gaps),
                                     num_hops=num_hops)
    assert rel_err(gp, wp) < TOL and rel_err(gv, wv) < TOL


@pytest.mark.parametrize("num_hops", [11, 16])
def test_propagate_gaps_with_jacobian_matches_jax(num_hops):
    pos, vel, gaps = _gap_case(7)
    wp, wv, wJ = jdyn.propagate_gaps_with_jacobian(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(gaps),
        num_hops=num_hops)
    gp, gv, gJ = dynamics.propagate_gaps_with_jacobian(
        T(pos), T(vel), T(gaps), num_hops=num_hops)
    assert rel_err(gp, wp) < TOL and rel_err(gv, wv) < TOL
    assert rel_err(gJ, wJ) < TOL


def test_hop_schedule_is_the_active_hops():
    gaps = np.array([0.0, 1.0, 100.0, 150.0, 999.0, 1000.0, 2000.0])
    hs = np.asarray(jdyn._hop_sizes(jnp.asarray(gaps), 16, 100.0,
                                    jnp.float64))
    for i, g in enumerate(gaps):
        assert dynamics.hop_schedule(g, 16, 100.0) == [
            float(h) for h in hs[:, i] if h > 0]
    assert dynamics.active_hops(gaps[:6], 100.0) == 10
