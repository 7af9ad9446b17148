"""Regenerate tests/data/torch_variants.npz: the JAX package's block-
tridiagonal solve variants on the systems of tests/test_torch_tridiag_
variants.py, and one LM iteration with its bcr16 solve (tests/test_torch_
variant_stream.py), committed so that the tests do not compile JAX for
them (each variant is a deep program: 0.5-3.5 s of compile a shape).

Runs the JAX package on the CPU in float64 and stores:

  * `jacobi_scaled_tridiag_solve` with each variant ("thomas", "chunked",
    "chunked_bcr", "bcr1", "bcr16") on the systems `system(N, case)` at
    N in SIZES, for case "one" (a single system), "own" (a batch of 2,
    jax.vmap, a U a system) and "shared" (a batch of 2 sharing one U and
    one scaling): key solve_<case>_<N>_<variant>;
  * the functions called directly on unscaled systems: the chunked SPIKE
    with the cyclic-reduction reduced solve (chunked_bcr_<chunks>) and
    with Thomas (chunked_thomas_<chunks>) at N=128, the general cyclic
    reduction `_tridiag_general_bcr` on a nonsymmetric system of 13 rows
    at bases 1 and 4 (general_bcr_<base>), `dense_from_blocks` (dense);
  * `ba_iteration` at schedule index 7 on a 60-knot orbit problem padded
    to 64 rows (tests/torch_parity.orbit_problem, seed 64, the dynamics
    factor on) with `tridiag_variant="bcr16"`: its inputs (iter_*) and
    the updated states (iter_states).

    python tests/data/make_torch_variants_fixture.py [--check]

--check recomputes everything and compares it with the committed file
(1e-14 relative) instead of overwriting it.
"""
from __future__ import annotations

import functools
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
sys.path.insert(0, os.path.join(HERE, ".."))

from vinsat_tpu.estimation import ba  # noqa: E402
from vinsat_tpu.estimation import window  # noqa: E402

PATH = os.path.join(HERE, "torch_variants.npz")
SIZES = (17, 64, 100, 130, 257)
VARIANTS = ("thomas", "chunked", "chunked_bcr", "bcr1", "bcr16")
CASES = ("one", "own", "shared")
CHUNKS = (4, 8)
BASES = (1, 4)


def system(N: int, case: str = "one", k: int = 9):
    """(D, U, b) numpy, seeded by N and case: SPD-dominant blocks
    (tests/test_tridiag_pallas.py's recipe) spread over ~1e6 like the
    normal equations.  case "one": D (N, k, k), U (N-1, k, k), b (N, k);
    "own": a leading batch of 2, each system its own U and scaling;
    "shared": a batch of 2 with one U (N-1, k, k) and one scaling."""
    rng = np.random.default_rng([N, CASES.index(case)])
    lead = () if case == "one" else (2,)
    A = rng.normal(size=lead + (N, k, k)) * 0.1
    D = np.einsum("...tij,...tkj->...tik", A, A) + np.eye(k) * 3.0
    U = rng.normal(size=(lead if case != "shared" else ()) + (N - 1, k, k))
    b = rng.normal(size=lead + (N, k))
    s = 10.0 ** rng.uniform(-3, 3, size=(lead if case != "shared" else ())
                            + (N, k))
    return (D * s[..., :, :, None] * s[..., :, None, :],
            0.05 * U * s[..., :-1, :, None] * s[..., 1:, None, :], b * s)


def unscaled(N: int, seed: int, k: int = 9):
    """tests/test_ba.py's recipe for the direct calls: D = AAᵀ + 8I,
    U ~ 0.4 N(0, 1), b ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(N, k, k))
    return (np.einsum("nij,nkj->nik", A, A) + 8 * np.eye(k),
            rng.normal(size=(N - 1, k, k)) * 0.4, rng.normal(size=(N, k)))


def general(C: int, seed: int, k: int = 18):
    """A nonsymmetric block-tridiagonal system of C rows of k (the chunked
    SPIKE's reduced system's shape): near-identity diagonal blocks,
    couplings below and above of 0.2 N(0, 1)."""
    rng = np.random.default_rng(seed)
    return (np.eye(k) + 0.3 * rng.normal(size=(C, k, k)),
            0.2 * rng.normal(size=(C, k, k)), 0.2 * rng.normal(size=(C, k, k)),
            rng.normal(size=(C, k)))


def _solve(case: str, variant: str):
    f = functools.partial(ba.jacobi_scaled_tridiag_solve, variant=variant)
    if case == "one":
        return jax.jit(f)
    return jax.jit(jax.vmap(f, in_axes=(0, 0 if case == "own" else None, 0)))


def _iteration():
    from torch_parity import orbit_problem, perturb

    rng = np.random.default_rng(64)
    gt, f = orbit_problem(rng, n_knots=60, obs_per_knot=6, gap=50.0)
    states = perturb(rng, gt, 5.0, 0.01)
    args = (states, f["gaps"], f["cum_rot"], f["landmarks_xyz"],
            f["landmarks_uv"], f["conf"], f["ii"], 64, 6 * 60)
    st, prob = window._pad_problem(*args, "float64")
    step = jax.jit(lambda s, p: ba.ba_iteration(
        7, s, p, jnp.asarray(1e-2), params=ba.SolverParams(
            num_hops=2, tridiag_variant="bcr16")))(st, prob)
    out = {"iter_states0": np.asarray(st),
           "iter_states": np.asarray(step.states)}
    out.update({f"iter_prob_{k}": np.asarray(v)
                for k, v in prob._asdict().items()})
    return out


def make(sizes=SIZES, cases=CASES, variants=VARIANTS,
         direct: bool = True) -> dict:
    out = {}
    for N in sizes:
        for case in cases:
            D, U, b = system(N, case)
            for v in variants:
                out[f"solve_{case}_{N}_{v}"] = np.asarray(
                    _solve(case, v)(D, U, b))
    if not direct:
        return out
    D, U, b = (jnp.asarray(a) for a in unscaled(128, 1))
    for C in CHUNKS:
        for red in ("bcr", "thomas"):
            out[f"chunked_{red}_{C}"] = np.asarray(
                ba.block_tridiag_solve_chunked(D, U, b, C, reduced=red))
    Dr, Ur, Lr, br = (jnp.asarray(a) for a in general(13, 2))
    for base in BASES:
        out[f"general_bcr_{base}"] = np.asarray(
            ba._tridiag_general_bcr(Dr, Ur, Lr, br, base=base))
    D, U, _ = unscaled(6, 3)
    out["dense"] = np.asarray(ba.dense_from_blocks(jnp.asarray(D),
                                                   jnp.asarray(U)))
    out.update(_iteration())
    return out


def differences(new: dict, old) -> dict:
    """{key: True where new[key] departs from the committed value by more
    than 1e-14 relative (XLA's CPU code may round apart on another CPU;
    the tests' bound is 1e-12)."""
    def same(v, o):
        return o.shape == v.shape and float(np.abs(v - o).max(initial=0.0)) \
            <= 1e-14 * float(np.abs(o).max(initial=0.0))
    return {k: not (k in old and same(v, old[k])) for k, v in new.items()}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    new = make()
    if "--check" in argv:
        diff = differences(new, np.load(PATH))
        bad = [k for k, d in diff.items() if d]
        print("differ:", bad if bad else "none")
        return 1 if bad else 0
    np.savez_compressed(PATH, **new)
    print(f"wrote {PATH}: {len(new)} arrays, "
          f"{os.path.getsize(PATH) / 1e6:.2f} MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
