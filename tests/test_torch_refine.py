"""PyTorch port vs JAX: estimation/refine (f64, CPU).

The rollout and its sensitivities agree to roundoff (1e-10 relative; the
port chains the hop Jacobians by a log-depth scan instead of a sequential
product).  The fits are 20-24 damped Gauss-Newton steps with accept /
reject decisions, held at 1e-6 relative."""
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import INTR, T, orbit_problem, perturb, rel_err
from vinsat_tpu.estimation import refine as jrefine
from vinsat_tpu_torch.estimation import refine


def _case(seed, n_knots=9, gap=150.0):
    rng = np.random.default_rng(seed)
    gt, f = orbit_problem(rng, n_knots=n_knots, obs_per_knot=6, gap=gap,
                          noise_px=2.0)
    st = perturb(rng, gt, pos_km=0.5, rot_rad=1e-3)
    st[:, 7:10] += rng.normal(size=(n_knots, 3)) * 1e-3
    return st, f


def test_rollout_with_sensitivity_matches_jax():
    x0 = np.array([6900.0, 10.0, -20.0, 0.01, 7.5, 0.3])
    gaps = np.array([5.0, 0.0, 150.0, 1000.0, 37.0, 999.0])
    wx, wP = jrefine._rollout_with_sensitivity(jnp.asarray(x0),
                                               jnp.asarray(gaps), 16, 100.0)
    gx, gP = refine._rollout_with_sensitivity(T(x0), gaps, 16, 100.0)
    assert rel_err(gx, wx) < 1e-10
    assert rel_err(gP, wP) < 1e-10


def _args(st, f):
    M = len(f["ii"])
    return (f["landmarks_xyz"], f["landmarks_uv"], f["conf"], f["ii"],
            np.ones(M), INTR)


@pytest.mark.parametrize("seed", [1, 2])
def test_refine_states_device_full_matches_jax(seed):
    st, f = _case(seed)
    args = _args(st, f)
    want = jrefine.refine_states_device_full(
        jnp.asarray(st), jnp.asarray(f["gaps"]), jnp.asarray(f["cum_rot"]),
        *[jnp.asarray(a) for a in args], num_hops=3)
    got = refine.refine_states_device_full(
        T(st), f["gaps"], T(f["cum_rot"]), *[T(a) for a in args],
        num_hops=3)
    assert rel_err(got, want) < 1e-6
    assert rel_err(got, st) > 0  # the fit moved the states


@pytest.mark.parametrize("fit", ["shooting_refine", "shooting_refine_rigid"])
def test_shooting_fits_match_jax(fit):
    st, f = _case(3)
    args = _args(st, f)
    extra = ((jnp.asarray(f["cum_rot"]),), (T(f["cum_rot"]),)) \
        if fit.endswith("rigid") else ((), ())
    want = getattr(jrefine, fit)(jnp.asarray(st), jnp.asarray(f["gaps"]),
                                 *extra[0], *[jnp.asarray(a) for a in args],
                                 num_hops=3)
    got = getattr(refine, fit)(T(st), f["gaps"], *extra[1],
                               *[T(a) for a in args], num_hops=3)
    for g, w in zip(got, want):
        assert rel_err(g, w) < 1e-6, fit


def test_refine_terminal_matches_jax():
    st, f = _case(4, n_knots=7)
    M = len(f["ii"])
    want = jrefine.refine_terminal(
        st, f["gaps"], f["landmarks_xyz"], f["landmarks_uv"], f["conf"],
        f["ii"], INTR, "float64", cum_rot=f["cum_rot"])
    got = refine.refine_terminal(
        st, f["gaps"], f["landmarks_xyz"], f["landmarks_uv"], f["conf"],
        f["ii"], INTR, cum_rot=f["cum_rot"], device="cpu")
    assert got.shape == (7, 10) and M > 0
    assert rel_err(got, want) < 1e-6
