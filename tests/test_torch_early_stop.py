"""PyTorch port vs JAX: the residual-gated early stop of the LM loop
(`_lm_loop` with SolverParams.conv_patience below the extra budget), on the
CPU in f64.

A scripted step (its residual read from a numpy-seeded table, its states
and λ counting the iterations) runs through both packages' `_lm_loop`, one
orbit at a time and as a batch of orbits that stop at different
iterations (JAX: jax.vmap of the while_loop; the port: its host loop with
the stopped orbits frozen): the iteration count, the returned best
iterate, its Hessian and residual equal.  Then real windows: a batch of
three orbit problems through `solve_window_batch` with the early stop,
against JAX's (its Thomas solve): states and residuals within 1e-9
relative, λ within 1e-12, and the loop ended before its budget."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (orbit_problem, perturb, rel_err,  # noqa: F401
                          torch_one_thread)
from vinsat_tpu.estimation import ba as jba
from vinsat_tpu.estimation import window as jwindow
from vinsat_tpu_torch.estimation import ba, window

PARAMS = dict(max_iters=40, conv_patience=3, conv_rtol=0.01)
NUM_ITERS, INIT_ITERS = 5, 2


def _tables(seed: int, n: int):
    """n residual chains of 40 iterations: falling by 5% an iteration, a
    bump at the init phase's end, then flat (with bumps below conv_rtol)
    from an iteration that differs per chain, so that each stops at its
    own iteration."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n):
        r = 10.0 * 0.95 ** np.arange(40)
        r[INIT_ITERS:] *= 1.5
        flat = int(rng.integers(6, 30))
        r[flat:] = r[flat] * (1.0 + 0.004 * rng.random(40 - flat))
        out.append(r)
    return np.stack(out)


def _jax_loop(table, params):
    def step_i(i, states, lam):
        return jba.BAStep(states + 1.0, lam + 1.0,
                          jnp.full((9, 9), 1.0) * i, table[i])

    return jwindow._lm_loop(step_i, jnp.zeros((4, 10)), 0.0, INIT_ITERS,
                            NUM_ITERS, params)


def _port_loop(tables, params):
    t = torch.as_tensor(tables)
    B = t.shape[0]

    def step_i(i, states, lam):
        return ba.BAStep(states + 1.0, lam + 1.0,
                         torch.full((B, 9, 9), float(i), dtype=t.dtype),
                         t[:, i])

    return window._lm_loop(step_i, torch.zeros((B, 4, 10),
                                               dtype=torch.float64),
                           0.0, INIT_ITERS, NUM_ITERS, params)


@pytest.mark.parametrize("seed", [0, 1])
def test_scripted_loop_single_orbit_matches_jax(seed):
    table = _tables(seed, 1)
    want = _jax_loop(jnp.asarray(table[0]), jba.SolverParams(**PARAMS))
    got = _port_loop(table, ba.SolverParams(**PARAMS))
    assert NUM_ITERS < float(want[1]) < PARAMS["max_iters"]  # it stopped
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


def test_scripted_loop_batch_matches_jax_vmap():
    tables = _tables(2, 5)
    want = jax.vmap(lambda tb: _jax_loop(tb, jba.SolverParams(**PARAMS)))(
        jnp.asarray(tables))
    got = _port_loop(tables, ba.SolverParams(**PARAMS))
    iters = np.asarray(want[1])
    assert len(set(iters.tolist())) >= 3  # the orbits stop apart
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_run_to_max_unchanged_by_patience():
    """conv_patience at the extra budget keeps the run-to-max loop (every
    orbit runs max_iters)."""
    tables = _tables(3, 3)
    params = dict(PARAMS, conv_patience=PARAMS["max_iters"] - NUM_ITERS)
    got = _port_loop(tables, ba.SolverParams(**params))
    assert (got[1] == PARAMS["max_iters"]).all()


@functools.lru_cache(maxsize=1)
def _windows():
    """Three orbit windows of 14 knots, padded to 16 x 84."""
    mine, ref = [], []
    for i in range(3):
        rng = np.random.default_rng(20 + i)
        gt, f = orbit_problem(rng, n_knots=14, obs_per_knot=6, gap=120.0)
        st = perturb(rng, gt, 5.0 * (i + 1), 0.01)
        args = (st, f["gaps"], f["cum_rot"], f["landmarks_xyz"],
                f["landmarks_uv"], f["conf"], f["ii"], 16, 84)
        mine.append(window._pad_problem(*args, "cpu"))
        ref.append(jwindow._pad_problem(*args, "float64"))
    return mine, ref


def test_solve_window_batch_early_stop_matches_jax(monkeypatch):
    mine, ref = _windows()
    params = dict(num_hops=2, max_iters=30, conv_patience=2, conv_rtol=0.05)
    lams = (1e-4, 1e-3, 1e-2)
    want = jwindow.solve_window_batch(
        jnp.stack([r[0] for r in ref]),
        jba.BAProblem(*[(jnp.stack([getattr(r[1], f) for r in ref])
                         if f != "intrinsics" else ref[0][1].intrinsics)
                        for f in jba.BAProblem._fields]),
        jnp.asarray(lams), jnp.asarray(2), 6,
        jba.SolverParams(tridiag_variant="thomas", **params))
    calls = []
    real = ba.ba_iteration

    def counted(*a, **k):
        calls.append(a[0])
        return real(*a, **k)

    monkeypatch.setattr(ba, "ba_iteration", counted)
    got = window.solve_window_batch(
        torch.stack([m[0] for m in mine]),
        ba.stack_problems([m[1] for m in mine]),
        torch.tensor(lams, dtype=torch.float64), 2, 6,
        ba.SolverParams(**params))
    assert rel_err(got[0], want[0]) < 1e-9
    assert rel_err(got[1], want[1]) < 1e-12
    assert rel_err(got[3], want[3]) < 1e-9
    # the early stop ran: the loop ended before the 30-iteration budget
    assert 6 < len(calls) < params["max_iters"]
