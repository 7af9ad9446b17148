"""The port with the JAX package's default f64 solve: JAX's "auto" rule off
the TPU (vinsat_tpu/estimation/ba.py:258-266: Thomas below 64 rows —
the "chunked" variant at one chunk —, bcr16 up to 1023, then the chunked
SPIKE) applied here by wrapping the port's dispatch, which keeps its own
"auto" (K1 from 64 rows).  JAX's runs are committed
(tests/data/torch_jax_runs_seed1.npz, tests/data/torch_variants.npz), so
no JAX program is compiled here.

Bounds: JAX's default stream (`plain30`) reproduced with the same
recorded times and every error within 1e-6 km (the port's own "auto" is
held at 1e-3 km, tests/test_torch_stream.py); one LM iteration with
bcr16 on both sides within 1e-9 relative, where K1 and bcr16 part by
1.3e-4 (tests/test_torch_constellation.py)."""
import collections
import functools
import os

import numpy as np
import pytest

from torch_parity import (T, jax_runs, jax_runs_arc, rel_err,  # noqa: F401
                          torch_one_thread)
from vinsat_tpu_torch import pipeline
from vinsat_tpu_torch.estimation import ba, window

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def jax_f64_variant(N: int) -> str:
    """JAX's "auto" choice for an f64 system of N block rows off the TPU."""
    if 64 <= N < 1024:
        return "bcr16"
    if N >= 1024 and N % 32 == 0:
        return "chunked_bcr"
    return "chunked"


@functools.lru_cache(maxsize=1)
def _stream():
    """The port's stream of the shared arc (JAX's plain30 configuration)
    with "auto" solves taking JAX's rule: (result, the variants taken
    with their counts)."""
    solve = ba.jacobi_scaled_tridiag_solve
    taken = collections.Counter()

    def dispatch(D, U, b, variant="auto"):
        if variant == "auto":
            variant = jax_f64_variant(D.shape[-3])
            taken[variant, D.shape[-3]] += 1
        return solve(D, U, b, variant=variant)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ba, "jacobi_scaled_tridiag_solve", dispatch)
        res = pipeline.run_streaming(
            jax_runs_arc(), seed=1, cfg=window.StreamingConfig(
                dtype="float64", max_iters=30), device="cpu")
    return res, taken


def test_stream_under_jax_rule_is_jax_default():
    got, taken = _stream()
    want = jax_runs("plain30")
    # the rule reached cyclic reduction, not only the plain scan
    assert any(v == "bcr16" for v, _ in taken), taken
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_allclose(got.errors, want.errors, rtol=0, atol=1e-6)
    assert got.first_detection == want.first_detection
    assert got.recovery_trips == int(want.recovery_trips)


def test_bcr16_iteration_matches_jax():
    """One ba_iteration (schedule index 7, λ0 1e-2, the dynamics factor
    on) on the 60-knot orbit problem padded to 64 rows, bcr16 on both
    sides (JAX's in tests/data/torch_variants.npz)."""
    fx = np.load(os.path.join(DATA, "torch_variants.npz"))
    prob = ba.problem_from_numpy(
        {k: fx[f"iter_prob_{k}"] for k in ba.BAProblem._fields}, "cpu")
    step = ba.ba_iteration(7, T(fx["iter_states0"]), prob, 1e-2,
                           params=ba.SolverParams(num_hops=2,
                                                  tridiag_variant="bcr16"))
    assert rel_err(step.states, fx["iter_states"]) < 1e-9
    # K1 (the port's "auto") parts from it by far more
    auto = ba.ba_iteration(7, T(fx["iter_states0"]), prob, 1e-2,
                           params=ba.SolverParams(num_hops=2))
    assert rel_err(auto.states, fx["iter_states"]) > 1e-9
