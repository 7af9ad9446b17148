"""Regenerate tests/data/torch_prior_coeffs.npz: the JAX package's two LM
paths with the window-marginal prior factor at non-default prior
coefficients (quat_coeff_prior, vel_coeff_prior) = COEFFS, inputs and
results, for the PyTorch port to be held to on the CPU and on the card.

  * `reg_*`: one `ba.ba_reg_iteration` (schedule index 12, λ 1e-4,
    `SolverParams(num_hops=4)` with the Thomas solve) on
    tests/test_torch_prior.py's case at 72 knots 45 s apart, padded to 80
    block rows (512 observation slots), with a prior on knots 4-71: its
    inputs (`reg_states0`, the BAProblem fields `reg_prob_*`, the
    PriorState fields `reg_prior_*`) and its outputs (`reg_out_*`).  At
    80 rows the port's f64 solve on the card is kernel K1 (the PCR solve
    from 64 rows on);
  * `solve_*`: `sharded_ba.make_sharded_window_solver` with a prior on
    tests/test_torch_dist_stream.py's 16-knot case over 4 arc shards (a
    4-device mesh), 3 iterations of which 1 vision-only, the last
    iterate returned: its ShardedProblem fields (`solve_prob_*`, one
    orbit), ShardedPrior fields (`solve_prior_*`) and outputs
    (`solve_out_0` states, `solve_out_1` λ, `solve_out_2` mean residual).
    On the card the port assembles its normal equations through kernel
    K2.

JAX runs on the CPU in float64 with 8 virtual devices, as the tests
configure it.  About 30 s; the file is ~60 kB.

    python tests/data/make_torch_prior_coeffs_fixture.py [--check]

--check recomputes everything and compares it with the committed file
(1e-12 relative) instead of overwriting it.
"""
from __future__ import annotations

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from vinsat_tpu.dist import mesh, sharded_ba  # noqa: E402
from vinsat_tpu.estimation import ba  # noqa: E402

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "torch_prior_coeffs.npz")
COEFFS = (0.5, 2.0)
REG_CASE = dict(seed=11, n_knots=72, n_pad=80, m_pad=512, gap=45.0)
REG_SCHED, REG_LAMDA, REG_PARAMS = 12, 1e-4, dict(num_hops=4)
# (shards, num_iters, max_iters, init_iters): the fixed budget
SOLVE_ARGS = (4, 3, 0, 1)


def _reg() -> dict:
    import test_torch_prior as t
    from torch_parity import jax_problem

    st0, fields, pri = t._case(**REG_CASE)
    want = jax.jit(ba.ba_reg_iteration, static_argnames=("params",))(
        jnp.asarray(REG_SCHED), jnp.asarray(st0), jax_problem(fields),
        ba.PriorState(*(jnp.asarray(a) for a in pri)), REG_LAMDA,
        params=ba.SolverParams(tridiag_variant="thomas", **REG_PARAMS),
        quat_coeff_prior=COEFFS[0], vel_coeff_prior=COEFFS[1])
    out = {"reg_states0": np.asarray(st0),
           "reg_case": np.array(json.dumps(REG_CASE)),
           "reg_sched_iter": np.array(REG_SCHED),
           "reg_lamda": np.array(REG_LAMDA),
           "reg_params": np.array(json.dumps(REG_PARAMS))}
    out.update({f"reg_prob_{k}": np.asarray(v) for k, v in fields.items()})
    out.update({f"reg_prior_{k}": np.asarray(v) for k, v in zip(
        ba.PriorState._fields, pri)})
    out.update({f"reg_out_{k}": np.asarray(getattr(want, k)) for k in (
        "states", "lamda_init", "last_hessian", "mean_residual")})
    return out


def _solve() -> dict:
    import test_torch_dist_stream as t

    fields, prior = t._case()
    P, num_iters, max_iters, init_iters = SOLVE_ARGS
    prob = sharded_ba.ShardedProblem(
        **{k: jnp.asarray(v)[None] for k, v in fields.items()},
        intrinsics=t.INTR)
    pri = sharded_ba.ShardedPrior(*(jnp.asarray(a)[None] for a in prior))
    solve = sharded_ba.make_sharded_window_solver(
        mesh.make_mesh(n_orbit=1, n_arc=P),
        ba.SolverParams(max_iters=max_iters, **t.PARAMS),
        num_iters=num_iters, init_iters=init_iters, with_prior=True,
        quat_coeff_prior=COEFFS[0], vel_coeff_prior=COEFFS[1])
    got = solve(jnp.full((1,), 1e-4), prob, pri)
    out = {"solve_args": np.array(SOLVE_ARGS),
           "solve_params": np.array(json.dumps(t.PARAMS)),
           "solve_prob_intrinsics": np.asarray(t.INTR)}
    out.update({f"solve_prob_{k}": np.asarray(v)[None]
                for k, v in fields.items()})
    out.update({f"solve_prior_{k}": np.asarray(v)[None] for k, v in zip(
        sharded_ba.ShardedPrior._fields, prior)})
    out.update({f"solve_out_{i}": np.asarray(v) for i, v in enumerate(got)})
    return out


def make() -> dict:
    return {"coeffs": np.array(COEFFS), **_reg(), **_solve()}


def main() -> None:
    ref = make()
    if "--check" in sys.argv[1:]:
        old = np.load(PATH)
        for k, v in ref.items():
            o = old[k]
            same = (np.array_equal(o, v) if o.dtype.kind in "iuUSb"
                    else np.allclose(o, v, rtol=1e-12, atol=0))
            print(f"{k}: {'ok' if same else 'DIFFERS'}")
        return
    np.savez_compressed(PATH, **ref)
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes): ba_reg_iteration "
          f"λ {float(ref['reg_out_lamda_init']):.1e}, mean residual "
          f"{float(ref['reg_out_mean_residual']):.6e}; sharded solve λ "
          f"{float(ref['solve_out_1'][0]):.1e}, mean residual "
          f"{float(ref['solve_out_2'][0]):.6e}")


if __name__ == "__main__":
    main()
