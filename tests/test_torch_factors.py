"""PyTorch port vs JAX: estimation/factors (f64, CPU), relative 1e-10."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import INTR, T, orbit_problem, perturb, rel_err
from vinsat_tpu.estimation import factors as jfactors
from vinsat_tpu_torch.estimation import factors

TOL = 1e-10


def _problem(seed):
    rng = np.random.default_rng(seed)
    gt, f = orbit_problem(rng, n_knots=7, obs_per_knot=5, gap=230.0)
    return perturb(rng, gt), f


def test_project_landmarks_matches_jax():
    st, f = _problem(0)
    want = jfactors.project_landmarks(jnp.asarray(st),
                                      jnp.asarray(f["landmarks_xyz"]),
                                      jnp.asarray(f["ii"]), jnp.asarray(INTR))
    got = factors.project_landmarks(T(st), T(f["landmarks_xyz"]), T(f["ii"]),
                                    T(INTR))
    assert rel_err(got, want) < TOL


@pytest.mark.parametrize("field", ["uv", "J"])
def test_reprojection_factor_matches_jax(field):
    st, f = _problem(1)
    want = jfactors.reprojection_factor(
        jnp.asarray(st), jnp.asarray(f["landmarks_xyz"]),
        jnp.asarray(f["ii"]), jnp.asarray(INTR))
    got = factors.reprojection_factor(T(st), T(f["landmarks_xyz"]),
                                      T(f["ii"]), T(INTR))
    assert rel_err(getattr(got, field), getattr(want, field)) < TOL


FIELDS = ["res_pv", "res_q", "A", "B", "qgrad", "Hq_diag", "Hq_off",
          "state_pred"]


def _dyn_args(seed):
    st, f = _problem(seed)
    vp = np.ones(st.shape[0] - 1)
    vp[-1] = 0.0  # a masked pair, as padding leaves them
    return st, f["gaps"], f["cum_rot"], vp


@pytest.mark.parametrize("field", FIELDS)
def test_dynamics_factor_matches_jax(field):
    st, gaps, cr, vp = _dyn_args(2)
    want = jfactors.dynamics_factor(jnp.asarray(st), jnp.asarray(gaps),
                                    jnp.asarray(cr), 100.0, 100.0,
                                    valid_pair=jnp.asarray(vp), num_hops=4)
    got = factors.dynamics_factor(T(st), T(gaps), T(cr), 100.0, 100.0,
                                  valid_pair=T(vp), num_hops=4)
    w = np.asarray(getattr(want, field))
    g = getattr(got, field)
    assert g.shape == w.shape
    assert rel_err(g, w) < TOL, field


def test_dynamics_factor_batched_residuals():
    """with_jacobian=False over a leading batch equals one call per
    member (the batched λ search relies on it)."""
    st, gaps, cr, vp = _dyn_args(3)
    rng = np.random.default_rng(3)
    batch = np.stack([perturb(rng, st, 1.0, 1e-3) for _ in range(3)])
    out = factors.dynamics_factor(T(batch), T(gaps), T(cr), 100.0, 100.0,
                                  valid_pair=T(vp), num_hops=4,
                                  with_jacobian=False)
    for b in range(3):
        want = jfactors.dynamics_factor(
            jnp.asarray(batch[b]), jnp.asarray(gaps), jnp.asarray(cr), 100.0,
            100.0, valid_pair=jnp.asarray(vp), num_hops=4,
            with_jacobian=False)
        assert rel_err(out.res_pv[b], want.res_pv) < TOL
        assert rel_err(out.res_q[b], want.res_q) < TOL


@pytest.mark.parametrize("T_len", [1, 2, 7, 97])
def test_cumulative_rotations_matches_jax(T_len):
    rng = np.random.default_rng(4)
    omega = rng.normal(size=(T_len, 3)) * 1e-3
    knots = np.unique(np.concatenate(
        [[0], rng.integers(0, T_len, size=min(T_len, 12))]))
    want = jfactors.cumulative_rotations(jnp.asarray(omega), 1.0,
                                         jnp.asarray(knots))
    got = factors.cumulative_rotations(T(omega), 1.0, T(knots))
    assert rel_err(got, want) < TOL


def test_inclusive_scan_is_an_ordered_prefix_product():
    rng = np.random.default_rng(5)
    m = T(rng.normal(size=(13, 3, 3)))
    got = factors._inclusive_scan(m, lambda a, b: a @ b)
    want = [m[0]]
    for i in range(1, 13):
        want.append(want[-1] @ m[i])
    assert rel_err(got, torch.stack(want)) < TOL
