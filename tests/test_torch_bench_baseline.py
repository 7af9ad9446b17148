"""The port's bench_baseline (the numpy per-iteration yardstick) against
the JAX package's, and the port's `window.solve_window` on bench.py's
per-iteration problem against JAX's result, committed in
tests/data/torch_vs_baseline.npz (tests/data/make_torch_vs_baseline_
fixture.py).

Bounds: the numpy baseline bit for bit (the same code on the same
inputs); the window solve one iteration at a time from JAX's own input
(both sides solve by the Thomas scan at N=32), since a one-ulp change of
the start moves JAX's own 10-iteration result by ~0.2 relative."""
import os

import numpy as np
import torch

from torch_parity import rel_err, torch_one_thread  # noqa: F401
from vinsat_tpu import bench_baseline as jbase
from vinsat_tpu_torch import bench_baseline
from vinsat_tpu_torch.estimation import ba, window

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_vs_baseline.npz")


def test_baseline_iteration_bit_equal():
    p = bench_baseline.bench_problem(N=8, M=64)
    x = np.concatenate([p["states9"][:, :3], p["states9"][:, 6:9]], axis=-1)
    np.testing.assert_array_equal(bench_baseline.propagate_all(x, 20),
                                  jbase.propagate_all(x, 20))
    got = bench_baseline.baseline_ba_iteration(p["states9"], p["ii"],
                                               p["uv"], p["lm"], max_gap=20)
    want = jbase.baseline_ba_iteration(p["states9"], p["ii"], p["uv"],
                                       p["lm"], max_gap=20)
    assert np.isfinite(got).all() and got.shape == (8 * 9,)
    np.testing.assert_array_equal(got, want)


PARAMS = ba.SolverParams(num_hops=12, max_substep=100.0)


def _bench_problem():
    fx = np.load(FIXTURE)
    p = bench_baseline.bench_problem()
    np.testing.assert_array_equal(
        [float(v.sum()) for v in p.values()], fx["problem_sums"])
    st0, prob = window._pad_problem(
        p["states"], p["gaps"], p["cum_rot"], p["lm"], p["uv"], p["conf"],
        p["ii"], 32, 256, "cpu")
    return fx, st0, prob


def test_iterations_match_jax():
    """Each of the 10 iterations from JAX's own input: JAX's λ, and states
    and residual within 1e-9 relative or 100x the move of JAX's result
    under a one-ulp change of that input, whichever is larger (the
    problem is chaotic: JAX's 10-iteration states move by ~0.2 under one
    ulp of the start, tests/data/make_torch_vs_baseline_fixture.py)."""
    fx, _, prob = _bench_problem()
    for k in range(10):
        step = ba.ba_iteration(k, torch.as_tensor(fx["step_states"][k]),
                               prob, float(fx["step_lamda"][k]),
                               params=PARAMS, initialize=False)
        tol = max(1e-9, 100.0 * float(fx["step_spread"][k]))
        assert float(step.lamda_init) == float(fx["step_lamda"][k + 1]), k
        assert rel_err(step.states, fx["step_states"][k + 1]) <= tol, k
        assert rel_err(step.mean_residual, fx["step_residual"][k]) <= tol, k


def test_solve_window_is_its_iterations():
    """The public name takes JAX's traced arguments and runs the 10
    iterations one after another (the schedule JAX's loop runs)."""
    _, st0, prob = _bench_problem()
    out = window.solve_window(st0, prob, 1e-4, torch.tensor(0), 10, PARAMS)
    states, lam = st0, torch.tensor(1e-4, dtype=torch.float64)
    for k in range(10):
        step = ba.ba_iteration(k, states, prob, lam, params=PARAMS,
                               initialize=False)
        states, lam = step.states, step.lamda_init
    assert torch.isfinite(out[0]).all()
    assert torch.equal(out[0], states) and torch.equal(out[1], lam)
    assert torch.equal(out[2], step.last_hessian)
    assert torch.equal(out[3], step.mean_residual)
    for g, w in zip(out, window._solve_window(st0, prob, 1e-4, 0, 10,
                                              PARAMS)):
        assert torch.equal(g, w)
