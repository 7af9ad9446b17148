"""Regenerate tests/data/torch_vs_baseline.npz: the JAX package's window
solve on bench.py's per-iteration problem (the problem behind the
benchmark's `vs_baseline`), for the PyTorch port to be held to.

The problem is built exactly as bench.py:146-167 builds it
(`default_rng(0)`, N=32 knots, M=256 observations, `_pad_problem` at
(N, M)), and JAX's `solve_window` runs on it on the CPU in float64:
`SolverParams(num_hops=12, max_substep=100.0)`, λ 1e-4, init_iters 0, 10
iterations.  At N=32 JAX's f64 "auto" solve is the chunked SPIKE at one
chunk, i.e. the plain Thomas scan.  Only the outputs are stored (the
problem is regenerated from the seed; `problem_sums` holds the sum of
each input array, in bench_baseline.bench_problem's key order, so that a
port whose problem differs is told so):

  * `states` (N, 10), `lamda`, `last_hessian` (9, 9), `mean_residual`:
    solve_window's four outputs;
  * `step_states` (11, N, 10), `step_lamda` (11,), `step_residual` (10,):
    the same 10 iterations one `ba_iteration` call at a time (jitted
    alone), entry 0 the padded start;
  * `step_spread` (10,) and `spread`: how far JAX's own result moves when
    the input states move by one ulp (the largest relative change over
    three such changes: every entry up, every entry down, each up or down
    by a seeded sign), for each single iteration and for the 10-iteration
    solve.

The problem is chaotic: a one-ulp change of the start moves JAX's
10-iteration states by ~0.1 relative, and JAX's fused loop and its
chained single iterations part by ~0.03, so a port is held to JAX one
iteration at a time, from JAX's own input (`step_*`), against
`step_spread`.  About 20 s on the CPU; the file is ~25 kB.

    python tests/data/make_torch_vs_baseline_fixture.py [--check]

--check recomputes everything and compares it with the committed file
(1e-12 relative) instead of overwriting it.
"""
from __future__ import annotations

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))

from vinsat_tpu.estimation import ba  # noqa: E402
from vinsat_tpu.estimation.window import _pad_problem, solve_window  # noqa

PATH = os.path.join(HERE, "torch_vs_baseline.npz")
N, M, ITERS = 32, 256, 10


def problem():
    """bench.py:146-162, verbatim but for the names."""
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(N, 3)) * 30 + np.array([6900.0, 0, 0])
    q = rng.normal(size=(N, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    vel = rng.normal(size=(N, 3)) * 0.1 + np.array([0, 7.5, 0])
    states = np.concatenate([pos, q, vel], axis=1)
    gaps = np.full(N, 350.0)
    gaps[-1] = 0
    cum = np.zeros((N, 4))
    cum[:, 3] = 1
    lm = pos[rng.integers(0, N, M)] * 0.92
    uv = rng.uniform(0, 2000, size=(M, 2))
    conf = rng.uniform(0.8, 1.0, M)
    ii = np.sort(rng.integers(0, N, M)).astype(np.int64)
    states9 = np.concatenate([pos, np.zeros((N, 3)), vel], axis=1)
    return dict(states=states, gaps=gaps, cum_rot=cum, lm=lm, uv=uv,
                conf=conf, ii=ii, states9=states9)


def _ulp_moves(x: np.ndarray):
    """x moved by one ulp: every entry up, every entry down, each by a
    seeded sign."""
    sign = np.random.default_rng(1).choice([-np.inf, np.inf], x.shape)
    return (np.nextafter(x, np.inf), np.nextafter(x, -np.inf),
            np.nextafter(x, sign))


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def make() -> dict:
    p = problem()
    st0, prob = _pad_problem(p["states"], p["gaps"], p["cum_rot"], p["lm"],
                             p["uv"], p["conf"], p["ii"], N, M, "float64")
    params = ba.SolverParams(num_hops=12, max_substep=100.0)

    def solve(s):
        return solve_window(s, prob, 1e-4, jnp.asarray(0), ITERS, params)

    out = solve(st0)
    spread = max(_rel(solve(jnp.asarray(s))[0], out[0])
                 for s in _ulp_moves(np.asarray(st0)))
    step = jax.jit(lambda i, s, lam: ba.ba_iteration(
        i, s, prob, lam, params=params, initialize=False),
        static_argnums=0)
    states, lams, res, spreads = [st0], [jnp.asarray(1e-4)], [], []
    for i in range(ITERS):
        o = step(i, states[-1], lams[-1])
        spreads.append(max(_rel(step(i, jnp.asarray(s), lams[-1]).states,
                                o.states)
                           for s in _ulp_moves(np.asarray(states[-1]))))
        states.append(o.states)
        lams.append(o.lamda_init)
        res.append(o.mean_residual)
    f = lambda xs: np.asarray(jnp.stack(xs), np.float64)  # noqa: E731
    s, lam, last_h, r = (np.asarray(x, np.float64) for x in out)
    return dict(states=s, lamda=lam, last_hessian=last_h, mean_residual=r,
                spread=np.array(spread), step_states=f(states),
                step_lamda=f(lams), step_residual=f(res),
                step_spread=np.array(spreads),
                problem_sums=np.array([float(v.sum()) for v in p.values()]))


def main() -> None:
    ref = make()
    if "--check" in sys.argv[1:]:
        old = np.load(PATH)
        for k, v in ref.items():
            same = np.allclose(old[k], v, rtol=1e-12, atol=0)
            print(f"{k}: {'ok' if same else 'DIFFERS'}")
        return
    np.savez_compressed(PATH, **ref)
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes): λ "
          f"{float(ref['lamda']):.3e}, mean residual "
          f"{float(ref['mean_residual']):.6e}; one-ulp spread "
          f"{float(ref['spread']):.3e} (10 iterations), a step "
          + ", ".join(f"{x:.1e}" for x in ref["step_spread"]))


if __name__ == "__main__":
    main()
