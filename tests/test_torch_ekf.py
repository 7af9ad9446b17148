"""PyTorch port vs JAX: the EKF (`predict`, `update`, `run_filter`,
`run_smoother`), the hybrid's `ekf_refine_window` and the matcher
`nearest_landmark`, on the same inputs (f64, CPU): knots every 100 s
along a JAX-simulated orbit, landmarks drawn with numpy around the
sub-satellite points, pixels projected by JAX plus 2 px noise, some
observation slots invalid.

Bound: relative 1e-9 for states and covariances (the filter runs 24 knots
of 9x9 and 16x16 inverses); `nearest_landmark`: indices equal and d2
within 1e-15 absolute, ties across a tile boundary included."""
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import (INTR, T, _trajectory, rel_err,  # noqa: F401
                          torch_one_thread)
from vinsat_tpu.core import quat as jquat
from vinsat_tpu.estimation import ekf as jekf
from vinsat_tpu.estimation import factors as jfactors
from vinsat_tpu.estimation import hybrid as jhybrid
from vinsat_tpu.kernels import matching as jmatching
from vinsat_tpu_torch.estimation import ekf, hybrid
from vinsat_tpu_torch.kernels import matching

TOL = 1e-9
CFG = dict(meas_noise_px=3.0, num_hops=3)


@functools.lru_cache(maxsize=1)
def _knots(n=24, gap=100, D=6):
    """GT knot states, gaps before each knot, IMU rotation before each
    knot, observation buffers (n, D, ...) and the flat observations."""
    rng = np.random.default_rng(11)
    traj = _trajectory()
    t_idx = np.arange(n) * gap
    pos = np.asarray(traj.pos_eci)[t_idx]
    gt = np.concatenate([pos, np.asarray(traj.quat_nadir_eci)[t_idx],
                         np.asarray(traj.vel_eci)[t_idx]], axis=1)
    omega = jquat.omega_from_sequence(traj.quat_nadir_eci, 1.0)
    cum = np.asarray(jfactors.cumulative_rotations(omega, 1.0,
                                                   jnp.asarray(t_idx)))
    cum_before = np.concatenate([[[0, 0, 0, 1.0]], cum[:-1]])
    lm = (pos[:, None] * (6378.0 / np.linalg.norm(pos, axis=-1))[:, None,
                                                                  None]
          + rng.normal(size=(n, D, 3)) * 30.0)
    uv = np.stack([np.asarray(jfactors.project_landmarks(
        jnp.asarray(gt[k:k + 1]), jnp.asarray(lm[k]),
        jnp.zeros(D, jnp.int32), jnp.asarray(INTR))) for k in range(n)])
    uv = uv + rng.normal(size=uv.shape) * 2.0
    ov = (rng.uniform(size=(n, D)) > 0.25).astype(float)
    gaps = np.concatenate([[0.0], np.full(n - 1, float(gap))])
    x0 = gt[0].copy()
    x0[:3] += np.array([20.0, -15.0, 10.0])
    x0[7:] += np.array([0.01, -0.02, 0.01])
    cov0 = np.diag([1e3] * 3 + [1e-2] * 3 + [1e-1] * 3)
    return dict(gt=gt, t_idx=t_idx, cum=cum, cum_before=cum_before, lm=lm,
                uv=uv, ov=ov, gaps=gaps, x0=x0, cov0=cov0)


def _args(k):
    return (k["x0"], k["cov0"], k["gaps"], k["cum_before"], k["lm"],
            k["uv"], k["ov"], INTR)


def test_predict_and_update_match_jax():
    k = _knots()
    cfg, jcfg = ekf.EKFConfig(**CFG), jekf.EKFConfig(**CFG)
    st = (k["gt"][3], np.diag(np.linspace(1e-4, 1e-2, 9)))
    want = jekf.predict(jekf.EKFState(*map(jnp.asarray, st)),
                        jnp.asarray(250.0), jnp.asarray(k["cum"][3]), jcfg)
    got = ekf.predict(ekf.EKFState(*map(T, st)), T(250.0), T(k["cum"][3]),
                      cfg)
    for g, w in zip(got, want):
        assert rel_err(g, w) < TOL
    want_u = jekf.update(want, *(jnp.asarray(a) for a in (
        k["lm"][4], k["uv"][4], k["ov"][4], INTR)), jcfg)
    got_u = ekf.update(got, T(k["lm"][4]), T(k["uv"][4]), T(k["ov"][4]),
                       T(INTR), cfg)
    for g, w in zip(got_u, want_u):
        assert rel_err(g, w) < TOL


@pytest.mark.parametrize("fn", ["run_filter", "run_smoother"])
def test_filter_and_smoother_match_jax(fn):
    k = _knots()
    want = getattr(jekf, fn)(*(jnp.asarray(a) for a in _args(k)),
                             jekf.EKFConfig(**CFG))
    got = getattr(ekf, fn)(*(T(a) for a in _args(k)), ekf.EKFConfig(**CFG))
    for g, w in zip(got, want):
        assert rel_err(g, w) < TOL
    err = np.linalg.norm(got[0].numpy()[:, :3] - k["gt"][:, :3], axis=-1)
    assert err[-1] < err[0]


def test_filter_predicted_sequences_match_jax():
    k = _knots()
    want = jekf.run_filter(*(jnp.asarray(a) for a in _args(k)),
                           jekf.EKFConfig(**CFG), return_predicted=True)
    got = ekf.run_filter(*(T(a) for a in _args(k)), ekf.EKFConfig(**CFG),
                         return_predicted=True)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert rel_err(g, w) < TOL


@pytest.mark.parametrize("return_prior", [False, True])
def test_ekf_refine_window_matches_jax(return_prior):
    k = _knots()
    n, D = k["ov"].shape
    valid = k["ov"].astype(bool)
    ii = np.repeat(np.arange(n), D)[valid.ravel()]
    graph = types.SimpleNamespace(ii=ii, uv=k["uv"].reshape(-1, 2)[
        valid.ravel()])
    gt = types.SimpleNamespace(
        landmarks_xyz=k["lm"].reshape(-1, 3)[valid.ravel()])
    H = np.linalg.inv(np.diag([4.0] * 3 + [1e-4] * 3 + [1e-6] * 3))
    kw = dict(num_hops=3, max_obs=4, return_prior=return_prior)
    args = (k["gt"][9], H, k["t_idx"], 10, 21, k["cum"], graph, gt, INTR)
    want = jhybrid.ekf_refine_window(*args, "float64", **kw)
    got = hybrid.ekf_refine_window(*args, device="cpu", **kw)
    if not return_prior:
        got, want = (got,), (want,)
    else:
        got = (got[0],) + tuple(got[1])
        want = (want[0],) + tuple(want[1])
    for g, w in zip(got, want):
        assert rel_err(g, w) < TOL


def test_build_knot_obs_buffers_matches_jax():
    rng = np.random.default_rng(12)
    ii = np.sort(rng.integers(0, 30, 200))
    graph = types.SimpleNamespace(ii=ii, uv=rng.normal(size=(200, 2)))
    gt = types.SimpleNamespace(landmarks_xyz=rng.normal(size=(200, 3)))
    for g, w in zip(hybrid.build_knot_obs_buffers(graph, gt, 5, 25, 8),
                    jhybrid.build_knot_obs_buffers(graph, gt, 5, 25, 8)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("L", [300, 1100])
def test_nearest_landmark_matches_jax(L):
    rng = np.random.default_rng(L)
    lon = rng.uniform(-180, 180, L)
    lat = rng.uniform(-80, 80, L)
    q = np.stack([lon[rng.integers(0, L, 150)] + rng.normal(size=150) * 0.3,
                  lat[rng.integers(0, L, 150)] + rng.normal(size=150) * 0.3],
                 axis=1)
    if L > 512:
        # the same landmark in two tiles, and twice within a tile: the
        # query on it must take the lower index, as JAX's strict < does
        lon[700], lat[700] = lon[5], lat[5]
        lon[9], lat[9] = lon[5], lat[5]
        lon[1050], lat[1050] = lon[600], lat[600]
        q[:4] = [[lon[5], lat[5]], [lon[600], lat[600]],
                 [lon[5] + 1e-3, lat[5]], [lon[600], lat[600] - 1e-3]]
    want_i, want_d = jmatching.nearest_landmark(
        jnp.asarray(q), jnp.asarray(lon), jnp.asarray(lat))
    got_i, got_d = matching.nearest_landmark(T(q), T(lon), T(lat))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=0,
                               atol=1e-15)
    if L > 512:
        assert got_i[:4].tolist() == [5, 600, 5, 600]
