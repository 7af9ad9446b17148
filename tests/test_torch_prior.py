"""PyTorch port vs JAX: the prior and bounded-window pieces (f64, CPU) on
the same inputs, made from a seed with numpy along a JAX-simulated orbit.

Bound: relative 1e-10 for `span_rotations`, `prior_factor`,
`terminal_marginal_info`, `inflate_info`, `propagate_prior` and one
`ba_reg_iteration` (states, last_hessian, mean_residual; λ equal) with the
sequential and the batched λ search.  `propagate_prior`'s H_state, the
inverse of a covariance of condition up to ~2e13, is held knot by knot to
the unit roundoff times its condition number (the measured error is
~1e-3 of that).  `solve_window_reg` (10 regularized iterations, JAX's
Thomas solve against the port's "auto", Thomas too at 16 rows): relative
1e-9."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import (T, jax_problem, numpy_fields, orbit_problem,
                          perturb, rel_err, torch_one_thread)  # noqa: F401
from vinsat_tpu import pipeline as jpipeline
from vinsat_tpu.core import quat as jquat
from vinsat_tpu.estimation import ba as jba
from vinsat_tpu.estimation import factors as jfactors
from vinsat_tpu.estimation import window as jwindow
from vinsat_tpu_torch.estimation import ba, factors, window

TOL = 1e-10


def _spd(rng, n, k, scale):
    A = rng.normal(size=(n, k, k))
    return (A @ np.swapaxes(A, -1, -2) + k * np.eye(k)) * scale


@functools.lru_cache(maxsize=None)
def _case(seed=0, n_knots=10, n_pad=16, m_pad=128):
    """A padded window (6 obs a knot), perturbed states, and a prior on
    knots 4..9: propagated states near GT, random SPD information."""
    rng = np.random.default_rng(seed)
    gt, f = orbit_problem(rng, n_knots=n_knots, obs_per_knot=6, gap=150.0)
    st = perturb(rng, gt, pos_km=5.0, rot_rad=0.01)
    st0, prob = jwindow._pad_problem(
        st, f["gaps"], f["cum_rot"], f["landmarks_xyz"], f["landmarks_uv"],
        f["conf"], f["ii"], n_pad, m_pad, "float64")
    prop = np.zeros((n_pad, 10))
    prop[:, 6] = 1.0
    prop[:n_knots] = perturb(rng, gt, pos_km=1.0, rot_rad=0.005)
    valid = np.zeros(n_pad)
    valid[4:n_knots] = 1.0
    Hs = _spd(rng, n_pad, 6, 1.0) * valid[:, None, None]
    Hr = _spd(rng, n_pad, 3, 100.0) * valid[:, None, None]
    return np.asarray(st0), numpy_fields(prob), (prop, Hs, Hr, valid)


def _jprior(pri):
    return jba.PriorState(*(jnp.asarray(a) for a in pri))


def _prior(pri):
    return ba.PriorState(*(T(a) for a in pri))


def test_span_rotations_matches_jax():
    rng = np.random.default_rng(1)
    omega = rng.normal(size=(400, 3)) * 1e-3
    ends = np.sort(rng.integers(60, 400, 12))
    want = jfactors.span_rotations(jnp.asarray(omega), 1.0, jnp.asarray(57),
                                   jnp.asarray(ends))
    got = factors.span_rotations(T(omega), 1.0, 57, T(ends))
    assert rel_err(got, want) < TOL


@pytest.mark.parametrize("lead", [(), (3,)])
def test_prior_factor_matches_jax(lead):
    st0, fields, pri = _case()
    rng = np.random.default_rng(2)
    states = st0 if not lead else np.stack(
        [perturb(rng, st0, 0.5, 0.001) for _ in range(lead[0])])
    fn = jfactors.prior_factor
    for k in range(states.shape[0] if lead else 1):
        s = states[k] if lead else states
        want = fn(jnp.asarray(s), jnp.asarray(pri[0]), jnp.asarray(pri[1]),
                  jnp.asarray(pri[2]), 1.0, 1.0, valid=jnp.asarray(pri[3]))
        got = factors.prior_factor(T(states), T(pri[0]), T(pri[1]),
                                   T(pri[2]), 1.0, 1.0, valid=T(pri[3]))
        for g, w in zip(got, want):
            assert rel_err(g[k] if lead else g, w) < TOL


def test_terminal_marginal_info_matches_jax():
    st0, fields, _ = _case()
    rng = np.random.default_rng(3)
    extra = np.zeros((16, 9, 9))
    extra[0] = _spd(rng, 1, 9, 10.0)[0]
    params = jba.SolverParams(num_hops=4)
    want = jba.terminal_marginal_info(jnp.asarray(st0), jax_problem(fields),
                                      params, extra_diag=jnp.asarray(extra))
    got = ba.terminal_marginal_info(
        T(st0), ba.problem_from_numpy(fields, "cpu"),
        ba.SolverParams(num_hops=4), extra_diag=T(extra))
    assert rel_err(got, want) < TOL


def test_inflate_info_matches_jax():
    H = _spd(np.random.default_rng(4), 1, 9, 1e4)[0]
    want = jba.inflate_info(H, 0.1, 0.01, 1e-4)
    assert rel_err(ba.inflate_info(H, 0.1, 0.01, 1e-4), want) < TOL


def test_propagate_prior_matches_jax():
    st0, fields, _ = _case()
    rng = np.random.default_rng(5)
    H = _spd(rng, 1, 9, 1e3)[0]
    spans = np.array([150.0, 300.0, 450.0, 1300.0])
    crot = np.asarray(jquat.exp(jnp.asarray(rng.normal(size=(4, 3)) * 0.1)))
    want = jba.propagate_prior(jnp.asarray(st0[3]), jnp.asarray(H),
                               jnp.asarray(spans), jnp.asarray(crot),
                               num_hops=14)
    got = ba.propagate_prior(T(st0[3]), T(H), T(spans), T(crot), num_hops=14)
    for name in ("prop_states", "H_rot", "valid"):
        assert rel_err(getattr(got, name), getattr(want, name)) < TOL, name
    # H_state inverts the propagated pos/vel covariance, whose condition
    # grows with the span (1e9 to 2e13 here): each knot's forward error
    # is held to the unit roundoff times that condition number
    for g, w in zip(got.H_state, np.asarray(want.H_state)):
        assert rel_err(g, w) < max(TOL, 1.1e-16 * np.linalg.cond(w))


@pytest.mark.parametrize("batched", [0, 9])
def test_ba_reg_iteration_matches_jax(batched):
    st0, fields, pri = _case()
    step = jax.jit(jba.ba_reg_iteration, static_argnames=("params",))
    want = step(jnp.asarray(12), jnp.asarray(st0), jax_problem(fields),
                _jprior(pri), 1e-4,
                params=jba.SolverParams(batched_lambda=batched, num_hops=4))
    got = ba.ba_reg_iteration(
        12, T(st0), ba.problem_from_numpy(fields, "cpu"), _prior(pri), 1e-4,
        params=ba.SolverParams(batched_lambda=batched, num_hops=4))
    assert float(got.lamda_init) == float(want.lamda_init)
    for name in ("states", "last_hessian", "mean_residual"):
        assert rel_err(getattr(got, name), getattr(want, name)) < TOL, name


def test_solve_window_reg_matches_jax():
    st0, fields, pri = _case()
    want = jwindow.solve_window_reg(
        jnp.asarray(st0), jax_problem(fields), _jprior(pri), 1e-4, 10,
        jba.SolverParams(num_hops=4, tridiag_variant="thomas"))
    got = window.solve_window_reg(
        T(st0), ba.problem_from_numpy(fields, "cpu"), _prior(pri), 1e-4, 10,
        ba.SolverParams(num_hops=4))
    for g, w in zip(got, want):
        assert rel_err(g, w) < 1e-9


def test_use_prior_stream_matches_jax():
    """`use_prior` on test_torch_stream.py's gapped arc at the fixed
    20-iteration budget (max_iters=0), against JAX with its Thomas solve.
    The mode's prior is the inverse of a propagated covariance of
    condition up to ~1e13 (test_propagate_prior_matches_jax), and on this
    arc it drives both streams away from the orbit (errors grow to ~90
    km, every later window trips): the same recorded times and trips, and
    each error within 1e-3 relative (+1e-3 km) of JAX's."""
    seq = jpipeline.simulate_sequence(1, duration_s=3600, frame_stride=10,
                                      along_track=True, pass_every_s=1200,
                                      pass_len_s=240)
    kw = dict(use_prior=True, max_iters=0)
    want = jwindow.stream_orbit(
        seq.det_rows, seq.orbit_pos_eci_km, seed=1,
        cfg=jwindow.StreamingConfig(**kw),
        solver=jba.SolverParams(tridiag_variant="thomas"))
    got = window.stream_orbit(seq.det_rows, seq.orbit_pos_eci_km, seed=1,
                              cfg=window.StreamingConfig(**kw), device="cpu")
    np.testing.assert_array_equal(got.times, want.times)
    assert got.recovery_trips == want.recovery_trips
    d = np.abs(got.errors - want.errors)
    np.testing.assert_allclose(got.errors, want.errors, rtol=1e-3, atol=1e-3)
