"""PyTorch port vs JAX: the simulator's frames, rollouts, MGRS zones,
orbits and landmark DB (f64, CPU).

Frames and rollouts (600 RK4 steps) are held to 1e-12 relative: the same
formulas in f64, differing only in summation order.  Zone lookup,
`synthesize` (numpy's generator on both sides) and the box tests are
exact.  The port's samplers draw from a torch.Generator, not JAX's
stream, so they are checked against their documented ranges."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import T, jax_trajectory_draws, rel_err
from vinsat_tpu.core import dynamics as jdyn
from vinsat_tpu.core import frames as jframes
from vinsat_tpu.sim import landmarks as jlm
from vinsat_tpu.sim import mgrs as jmgrs
from vinsat_tpu.sim import orbits as jorbits
from vinsat_tpu_torch.core import dynamics, frames
from vinsat_tpu_torch.sim import landmarks, mgrs, orbits

STEPS = 600


def _ecef_points(rng, n=64):
    return (rng.normal(size=(n, 3)) * 3000.0
            + rng.choice([-1.0, 1.0], size=(n, 3)) * 4000.0)


def test_ecef_to_geodetic_matches_jax():
    r = _ecef_points(np.random.default_rng(0))
    for got, want in zip(frames.ecef_to_geodetic(T(r)),
                         jframes.ecef_to_geodetic(jnp.asarray(r))):
        assert rel_err(got, want) < 1e-12


def test_nadir_axes_match_jax():
    r = _ecef_points(np.random.default_rng(1))
    for got, want in zip(frames.nadir_axes(T(r)),
                         jframes.nadir_axes(jnp.asarray(r))):
        assert rel_err(got, want) < 1e-12


def test_attitude_dynamics_match_jax():
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.normal(size=(8, 4)),
                        rng.normal(size=(8, 3)) * 0.05], axis=1)
    assert rel_err(dynamics.attitude_dynamics(T(x)),
                   jdyn.attitude_dynamics(jnp.asarray(x))) < 1e-12
    assert rel_err(dynamics.attitude_rk4_step(T(x), 1.0),
                   jdyn.attitude_rk4_step(jnp.asarray(x), 1.0)) < 1e-12
    assert np.allclose(dynamics.INERTIA_3U, jdyn.INERTIA_3U, rtol=0, atol=0)


def test_rollouts_match_jax():
    x0 = np.array([6900.0, 10.0, -20.0, 0.01, 7.5, 0.3])
    got = dynamics.rollout_orbit(T(x0), STEPS, 1.0)
    want = jdyn.rollout_orbit(jnp.asarray(x0), STEPS, 1.0)
    assert got.shape == (STEPS + 1, 6) and rel_err(got, want) < 1e-12
    a0 = np.array([0.1, -0.5, 0.3, 0.8, 0.03, -0.02, 0.01])
    got = dynamics.rollout_attitude(T(a0), STEPS, 1.0)
    want = jdyn.rollout_attitude(jnp.asarray(a0), STEPS, 1.0)
    assert got.shape == (STEPS + 1, 7) and rel_err(got, want) < 1e-12


def test_zone_tables_match_jax():
    assert mgrs.ZONE_LABELS == jmgrs.ZONE_LABELS
    np.testing.assert_array_equal(mgrs.ZONE_BOUNDS, jmgrs.ZONE_BOUNDS)
    assert mgrs.ACTIVE_REGIONS == jmgrs.ACTIVE_REGIONS
    np.testing.assert_array_equal(mgrs.active_region_mask("cpu").numpy(),
                                  np.asarray(jmgrs.active_region_mask()))


def test_zone_of_matches_jax():
    rng = np.random.default_rng(3)
    lon = rng.uniform(-185.0, 185.0, 2000)
    lat = rng.uniform(-88.0, 88.0, 2000)
    # shared edges and corners (first zone in table order), and no zone
    lon[:8] = [0.0, 6.0, -180.0, 180.0, 3.0, 9.0, 12.0, 0.0]
    lat[:8] = [0.0, 8.0, -80.0, 84.0, 60.0, 72.0, 64.0, -85.0]
    got = mgrs.zone_of(T(lon), T(lat)).numpy()
    want = np.asarray(jmgrs.zone_of(jnp.asarray(lon), jnp.asarray(lat)))
    np.testing.assert_array_equal(got, want)
    assert (got == -1).any() and got[7] == -1


@functools.lru_cache(maxsize=1)
def _jax_traj():
    key = jax.random.PRNGKey(5)
    return jax_trajectory_draws(key), jorbits.generate_trajectory(
        key, duration_s=STEPS)


def test_oe_conversions_match_jax():
    (oe, _, _), jt = _jax_traj()
    want = jorbits.oe_to_eci(jorbits.OrbitalElements(*jnp.asarray(oe)))
    got = orbits.oe_to_eci(orbits.OrbitalElements(*T(oe)))
    assert rel_err(got, want) < 1e-12
    x = np.concatenate([np.asarray(jt.pos_eci), np.asarray(jt.vel_eci)],
                       axis=1)[::50]
    for g, w in zip(orbits.eci_to_oe(T(x)), jorbits.eci_to_oe(jnp.asarray(x))):
        assert rel_err(g, w) < 1e-10  # arccos near 0 and 2π amplifies


def test_trajectory_from_draws_matches_jax():
    (oe, q0, w0), jt = _jax_traj()
    got = orbits.trajectory_from_draws(orbits.OrbitalElements(*oe), q0, w0,
                                       duration_s=STEPS, device="cpu")
    for name in orbits.Trajectory._fields:
        assert rel_err(getattr(got, name), getattr(jt, name)) < 1e-12, name
    assert rel_err(got.pos_ecef, jt.pos_ecef) < 1e-12


def test_samplers_draw_documented_ranges():
    g = torch.Generator().manual_seed(0)
    incl = []
    for _ in range(200):
        oe = orbits.sample_random_oe(g)
        alt = oe.a - orbits.R_EARTH_KM
        assert 525.0 <= alt <= 575.0 and 0.0 <= oe.e <= 0.01
        assert oe.Omega == oe.omega == oe.nu and 0 <= oe.nu < 2 * math.pi
        incl.append(oe.i)
    incl = np.rad2deg(incl)
    polar = np.abs(incl - 90.0) <= np.rad2deg(0.1)
    iss = np.abs(incl - 51.5) <= np.rad2deg(0.05)
    assert (polar | iss).all() and 60 < polar.sum() < 140
    q0, w0 = orbits.sample_attitude(g)
    assert abs(float(q0.norm()) - 1.0) < 1e-15 and w0.shape == (3,)
    a = orbits.generate_trajectory(torch.Generator().manual_seed(3),
                                   duration_s=10, device="cpu")
    b = orbits.generate_trajectory(torch.Generator().manual_seed(3),
                                   duration_s=10, device="cpu")
    assert torch.equal(a.pos_eci, b.pos_eci) and a.pos_eci.shape == (11, 3)


@pytest.mark.parametrize("per_region,best_fraction", [(495, 0.2),
                                                      (37, 0.5)])
def test_synthesize_matches_jax_bit_for_bit(per_region, best_fraction):
    key = jax.random.PRNGKey(11)
    seed = int(np.asarray(jax.random.key_data(key)).ravel()[-1]) & 0x7FFFFFFF
    want = jlm.synthesize(key, per_region=per_region,
                          best_fraction=best_fraction)
    got = landmarks.synthesize(seed, per_region=per_region,
                               best_fraction=best_fraction, device="cpu")
    assert got.num_landmarks == want.num_landmarks == 16 * per_region
    for name in landmarks.LandmarkDB._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    carried = landmarks.db_from_numpy(
        {k: np.asarray(v) for k, v in want._asdict().items()}, "cpu")
    for name in landmarks.LandmarkDB._fields:
        assert torch.equal(getattr(carried, name), getattr(got, name))


def test_box_tests_match_jax():
    key = jax.random.PRNGKey(2)
    jdb = jlm.synthesize(key, per_region=60)
    db = landmarks.db_from_numpy(jdb._asdict(), "cpu")
    rng = np.random.default_rng(4)
    c = np.stack([np.asarray(jdb.lon)[::97], np.asarray(jdb.lat)[::97]], 1)
    h = rng.uniform(0.5, 4.0, size=(len(c), 2))
    bounds = np.concatenate([c - h, c + h], axis=1)
    bounds[:3, 0] = 178.0  # wrapped boxes
    bounds[:3, 2] = 190.0
    active = jmgrs.active_region_mask()
    for args in ((), (active,)):
        want = np.asarray(jlm.visible_best_count(jdb, jnp.asarray(bounds),
                                                 *args))
        got = landmarks.visible_best_count(
            db, T(bounds), *(torch.as_tensor(np.array(a)) for a in args))
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.sum() > 0
    np.testing.assert_array_equal(
        landmarks.in_bounds_mask(db, T(bounds)).numpy(),
        np.asarray(jlm.in_bounds_mask(jdb, jnp.asarray(bounds))))
