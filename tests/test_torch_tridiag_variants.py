"""The JAX package's block-tridiagonal solve variants in the port
(estimation/ba.py: chunked SPIKE with a Thomas or cyclic-reduction reduced
solve, block cyclic reduction to a base of 1 or 16 rows) against JAX's
own, f64 on the CPU.

JAX's results are committed (tests/data/make_torch_variants_fixture.py):
each variant is a deep program that takes JAX 0.5-3.5 s to compile a
shape; one test a variant holds the committed file to a fresh JAX run.

Bounds: a variant within 1e-12 relative of JAX's same variant (the same
operations in the same order; the feasibility run read 3e-17), and within
1e-9 of JAX's Thomas solve (tests/test_ba.py's bound between the
variants); `dense_from_blocks` exactly equal.  In f32 on ill-scaled,
Jacobi-scaled blocks, bcr16's median relative error against f64 stays
under 1e-3 (tests/test_ba.py::test_bcr_f32_with_jacobi_scaling).
"""
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from torch_parity import T, rel_err, torch_one_thread  # noqa: F401
from vinsat_tpu.estimation import ba as jba
from vinsat_tpu_torch.estimation import ba

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
TOL_SAME = 1e-12
TOL_THOMAS = 1e-9


@functools.lru_cache(maxsize=1)
def _maker():
    spec = importlib.util.spec_from_file_location(
        "make_torch_variants_fixture",
        os.path.join(DATA, "make_torch_variants_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fx():
    return np.load(os.path.join(DATA, "torch_variants.npz"))


@pytest.mark.parametrize("case", ["one", "own", "shared"])
@pytest.mark.parametrize("N", [17, 64, 100, 130, 257])
def test_variants_match_jax(N, case, fx):
    """Every variant of `jacobi_scaled_tridiag_solve`, one system or a
    batch of 2 (a U a system, or one U for both: U without the batch
    axis, as the λ search hands it over)."""
    D, U, b = (T(a) for a in _maker().system(N, case))
    thomas = fx[f"solve_{case}_{N}_thomas"]
    for v in _maker().VARIANTS:
        got = ba.jacobi_scaled_tridiag_solve(D, U, b, variant=v)
        assert got.shape == b.shape
        assert rel_err(got, fx[f"solve_{case}_{N}_{v}"]) < TOL_SAME, v
        assert rel_err(got, thomas) < TOL_THOMAS, v


def test_chunked_spike_direct(fx):
    """block_tridiag_solve_chunked called directly (unscaled blocks), with
    each reduced solve, at 4 and 8 chunks."""
    D, U, b = (T(a) for a in _maker().unscaled(128, 1))
    for C in _maker().CHUNKS:
        for red in ("bcr", "thomas"):
            got = ba.block_tridiag_solve_chunked(D, U, b, C, reduced=red)
            assert rel_err(got, fx[f"chunked_{red}_{C}"]) < TOL_SAME, (C,
                                                                       red)


def test_general_bcr_direct(fx):
    """_tridiag_general_bcr on a nonsymmetric system of 13 rows (padded
    to 16, pivoted block solves) at bases 1 and 4, against JAX's and
    against the pivoted general Thomas recursion."""
    Dr, Ur, Lr, br = (T(a) for a in _maker().general(13, 2))
    thomas = ba._tridiag_general(Dr, Ur[:-1], Lr, br)
    for base in _maker().BASES:
        got = ba._tridiag_general_bcr(Dr, Ur, Lr, br, base=base)
        assert rel_err(got, fx[f"general_bcr_{base}"]) < TOL_SAME, base
        assert rel_err(got, thomas) < TOL_THOMAS, base


def test_dense_from_blocks_is_jax(fx):
    D, U, _ = _maker().unscaled(6, 3)
    H = ba.dense_from_blocks(T(D), T(U))
    np.testing.assert_array_equal(H.numpy(), fx["dense"])


def test_chunked_needs_a_divisor():
    D, U, b = (T(a) for a in _maker().system(17, "one"))
    with pytest.raises(ValueError, match="multiple"):
        ba.block_tridiag_solve_chunked(D, U, b, 4)


def test_unknown_variant_raises():
    D, U, b = (T(a) for a in _maker().system(17, "one"))
    with pytest.raises(ValueError, match="unknown tridiag variant"):
        ba.jacobi_scaled_tridiag_solve(D, U, b, variant="qr")


def test_chunk_counts_are_jax():
    for n in (17, 64, 100, 128, 130, 256, 448, 768, 1024, 2560, 4096):
        assert ba._auto_chunks(n) == jba._auto_chunks(n), n
        assert ba._bcr_chunks(n) == jba._bcr_chunks(n), n


def test_bcr16_f32_with_jacobi_scaling():
    """tests/test_ba.py's f32 case: blocks spanning ~1e10, Jacobi-scaled,
    bcr16 in f32 against the f64 solve."""
    rng = np.random.default_rng(0)
    N, k = 128, 9
    scales = 10.0 ** rng.uniform(0, 5, (N, k))
    A = rng.normal(size=(N, k, k))
    D = np.einsum("nij,nkj->nik", A, A) + 5 * np.eye(k)
    D = D * scales[:, :, None] * scales[:, None, :]
    U = rng.normal(size=(N - 1, k, k)) * 0.2
    U = U * scales[:-1, :, None] * scales[1:, None, :] * 0.01
    b = rng.normal(size=(N, k)) * scales
    x64 = ba.jacobi_scaled_tridiag_solve(T(D), T(U), T(b),
                                         variant="bcr16").numpy()
    x32 = ba.jacobi_scaled_tridiag_solve(
        T(D, torch.float32), T(U, torch.float32), T(b, torch.float32),
        variant="bcr16").numpy()
    rel = np.abs(x32 - x64) / np.maximum(np.abs(x64), 1e-12)
    assert np.median(rel) < 1e-3, np.median(rel)


@pytest.mark.parametrize("variant", ["thomas", "chunked", "chunked_bcr",
                                     "bcr1", "bcr16"])
def test_fixture_is_jax_today(variant, fx):
    """The committed results of one size are what JAX computes today."""
    maker = _maker()
    diff = maker.differences(
        maker.make(sizes=(64,), cases=("one",), variants=(variant,),
                   direct=False), fx)
    assert not any(diff.values()), [k for k, bad in diff.items() if bad]
