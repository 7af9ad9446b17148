"""PyTorch port vs JAX: one `ba_iteration` on the same padded problem
(f64, CPU), with the sequential and the batched (K=9) λ search.

At this N (16 padded rows) the JAX package solves the damped system by
Thomas, and so does the port's "auto" dispatch (Thomas below 64 rows, as
JAX's f64 "auto"): λ equal, states relative 1e-8, mean_residual and
last_hessian relative 1e-9 for both the "thomas" and the "auto" case.
(Forced to PCR, kernel K1's algorithm, the states still agree to ~1e-12,
but the trial residual mean, which weighs differences of ~7000 km
positions by sqrt(Σ)=1e3, moves by ~1e-8 relative.)"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (INTR, T, jax_problem, numpy_fields,
                          orbit_problem, perturb, rel_err)
from vinsat_tpu.estimation import ba as jba
from vinsat_tpu.estimation import window as jwindow
from vinsat_tpu_torch.estimation import ba


@functools.lru_cache(maxsize=None)
def _padded(seed, n_knots=10, n_pad=16, m_pad=128):
    rng = np.random.default_rng(seed)
    gt, f = orbit_problem(rng, n_knots=n_knots, obs_per_knot=6, gap=150.0)
    st = perturb(rng, gt, pos_km=5.0, rot_rad=0.01)
    st0, prob = jwindow._pad_problem(
        st, f["gaps"], f["cum_rot"], f["landmarks_xyz"], f["landmarks_uv"],
        f["conf"], f["ii"], n_pad, m_pad, "float64")
    return np.asarray(st0), numpy_fields(prob)


@functools.lru_cache(maxsize=None)
def _jax_step(sched_iter, initialize, batched):
    st0, fields = _padded(sched_iter)
    step = jax.jit(jba.ba_iteration, static_argnames=("params", "initialize"))
    return step(jnp.asarray(sched_iter), jnp.asarray(st0),
                jax_problem(fields), 1e-4,
                params=jba.SolverParams(batched_lambda=batched, num_hops=4),
                initialize=initialize)


@pytest.mark.parametrize("variant,res_tol", [("thomas", 1e-9),
                                             ("auto", 1e-9)])
@pytest.mark.parametrize("batched", [0, 9])
@pytest.mark.parametrize("sched_iter,initialize", [(0, True), (12, False)])
def test_ba_iteration_matches_jax(variant, res_tol, batched, sched_iter,
                                  initialize):
    want = _jax_step(sched_iter, initialize, batched)
    st0, fields = _padded(sched_iter)
    prob = ba.problem_from_numpy(fields, "cpu")
    got = ba.ba_iteration(sched_iter, T(st0), prob, 1e-4,
                          params=ba.SolverParams(batched_lambda=batched,
                                                 num_hops=4,
                                                 tridiag_variant=variant),
                          initialize=initialize)
    assert float(got.lamda_init) == float(want.lamda_init)
    assert rel_err(got.states, want.states) < 1e-8
    assert rel_err(got.mean_residual, want.mean_residual) < res_tol
    assert rel_err(got.last_hessian, want.last_hessian) < 1e-9


def test_solver_params_from_jax():
    jp = jba.SolverParams(batched_lambda=9, max_iters=60)
    assert ba.SolverParams(**jp._asdict())._asdict() == jp._asdict()


def test_batched_lambda_matches_sequential():
    st0, fields = _padded(5)
    prob = ba.problem_from_numpy(fields, "cpu")
    lam = 1e-4
    outs = [ba.ba_iteration(2, T(st0), prob, lam,
                            params=ba.SolverParams(batched_lambda=k,
                                                   num_hops=4))
            for k in (0, 9)]
    assert float(outs[0].lamda_init) == float(outs[1].lamda_init)
    assert rel_err(outs[1].states, outs[0].states) < 1e-12


def test_ba_padding_invariance():
    """Padded problem (extra knots + obs with valid=0) gives the same update
    on the real knots (tests/test_ba.py's invariant, for the port)."""
    rng = np.random.default_rng(3)
    gt, f = orbit_problem(rng, n_knots=4, obs_per_knot=8, gap=150.0)
    st = perturb(rng, gt, pos_km=5.0, rot_rad=0.0)
    n, M = 4, len(f["ii"])
    f_ref = dict(f, obs_valid=np.ones(M), knot_valid=np.ones(n),
                 pair_valid=np.ones(n - 1), intrinsics=INTR)
    ref = ba.ba_iteration(3, T(st), ba.problem_from_numpy(f_ref, "cpu"), 1e-4)

    n_pad, extra_m = 6, 16
    st_p = np.concatenate([st, np.tile([0.0, 0, 0, 0, 0, 0, 1.0, 0, 0, 0],
                                       (2, 1))])
    cr = np.zeros((2, 4))
    cr[:, 3] = 1.0
    f_pad = dict(
        gaps=np.concatenate([f["gaps"], np.zeros(2)]),
        cum_rot=np.concatenate([f["cum_rot"], cr]),
        landmarks_xyz=np.concatenate([f["landmarks_xyz"],
                                      np.zeros((extra_m, 3))]),
        landmarks_uv=np.concatenate([f["landmarks_uv"],
                                     np.zeros((extra_m, 2))]),
        conf=np.concatenate([f["conf"], np.zeros(extra_m)]),
        ii=np.concatenate([f["ii"], np.zeros(extra_m, np.int64)]),
        obs_valid=np.concatenate([np.ones(M), np.zeros(extra_m)]),
        knot_valid=np.concatenate([np.ones(n), np.zeros(2)]),
        pair_valid=np.concatenate([np.ones(n - 1), np.zeros(2)]),
        intrinsics=INTR)
    pad = ba.ba_iteration(3, T(st_p), ba.problem_from_numpy(f_pad, "cpu"),
                          1e-4)
    assert n_pad == pad.states.shape[0]
    torch.testing.assert_close(pad.states[:n], ref.states, rtol=1e-7,
                               atol=1e-9)


def test_masked_median_and_weights_match_jax():
    rng = np.random.default_rng(6)
    r = rng.normal(size=(40, 2)) * 3.0
    r[3] = 80.0
    valid = (rng.uniform(size=40) > 0.2).astype(float)
    conf = rng.uniform(0.8, 1.0, 40)
    assert rel_err(ba._masked_median(T(r), T(valid)),
                   jba._masked_median(jnp.asarray(r), jnp.asarray(valid))) == 0
    for it in (0, 2, 10):
        want = jba.robust_weights(jnp.asarray(r), jnp.asarray(conf),
                                  jnp.asarray(valid), jnp.asarray(it))
        got = ba.robust_weights(T(r), T(conf), T(valid), it)
        assert rel_err(got, want) < 1e-12, it


def test_gj_solve_small_matches_jax():
    rng = np.random.default_rng(7)
    A = rng.normal(size=(5, 9, 9)) + 4 * np.eye(9)
    B = rng.normal(size=(5, 9, 3))
    for pivot in (False, True):
        want = jba.gj_solve_small(jnp.asarray(A), jnp.asarray(B), pivot=pivot)
        got = ba.gj_solve_small(T(A), T(B), pivot=pivot)
        assert rel_err(got, want) < 1e-12, pivot
