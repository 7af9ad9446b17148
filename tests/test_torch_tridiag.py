"""Kernel K1 (kernels/tridiag_pcr): the plain PyTorch PCR against the JAX
Pallas kernel (interpret mode) and the JAX Thomas solve, and the port's
Jacobi-scaled dispatch against the JAX one — relative 1e-9 in f64, as
tests/test_tridiag_pallas.py holds the Pallas kernel.  The CUDA kernel
itself is compared with its plain twin in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import T, rel_err
from vinsat_tpu.estimation import ba as jba
from vinsat_tpu.kernels.tridiag_pallas import block_tridiag_solve_pallas
from vinsat_tpu_torch.estimation import ba
from vinsat_tpu_torch.kernels import tridiag_pcr

TOL = 1e-9


def _problem(rng, N, k=9, B=None):
    """tests/test_tridiag_pallas.py's SPD-dominant blocks (B systems)."""
    lead = () if B is None else (B,)
    A = rng.normal(size=lead + (N, k, k)) * 0.1
    D = np.einsum("...tij,...tkj->...tik", A, A) + np.eye(k) * 3.0
    U = rng.normal(size=lead + (N - 1, k, k)) * 0.05
    b = rng.normal(size=lead + (N, k))
    return D, U, b


def _scaled(rng, D, U, b):
    """Spread the blocks over ~1e6, like the normal equations."""
    N, k = D.shape[-3], D.shape[-1]
    s = 10.0 ** rng.uniform(-3, 3, size=(N, k))
    return (D * s[:, :, None] * s[:, None, :],
            U * s[:-1, :, None] * s[1:, None, :], b * s)


def _pallas_128(D, U, b):
    """The JAX Pallas kernel in interpret mode on the system padded to 128
    rows with identity blocks — the padding the kernel applies itself, done
    here so every N <= 128 shares one compiled shape (interpret mode
    compiles for ~10 s per shape)."""
    N, n = D.shape[0], 128
    Dp = np.broadcast_to(np.eye(9), (n, 9, 9)).copy()
    Dp[:N] = D
    Up = np.zeros((n - 1, 9, 9))
    Up[:N - 1] = U
    bp = np.zeros((n, 9))
    bp[:N] = b
    return np.asarray(block_tridiag_solve_pallas(
        jnp.asarray(Dp), jnp.asarray(Up), jnp.asarray(bp),
        interpret=True))[:N]


@pytest.mark.parametrize("N", [5, 16, 64, 200, 257])
def test_plain_pcr_matches_pallas_and_thomas(N):
    rng = np.random.default_rng(N)
    D, U, b = _problem(rng, N, B=2)
    got = tridiag_pcr.block_tridiag_solve_pcr(T(D), T(U), T(b))
    for i in range(2):
        args = (jnp.asarray(D[i]), jnp.asarray(U[i]), jnp.asarray(b[i]))
        thomas = np.asarray(jba.block_tridiag_solve(*args))
        assert rel_err(got[i], thomas) < TOL, (N, i, "thomas")
    if N <= 128:
        assert rel_err(got[0], _pallas_128(D[0], U[0], b[0])) < TOL, N


def test_plain_pcr_shared_u_and_unbatched():
    rng = np.random.default_rng(11)
    D, U, b = _problem(rng, 37, B=3)
    shared = tridiag_pcr.block_tridiag_solve_pcr(T(D), T(U[0]), T(b))
    for i in range(3):
        one = tridiag_pcr.block_tridiag_solve_pcr(T(D[i]), T(U[0]), T(b[i]))
        assert one.shape == (37, 9)
        assert rel_err(shared[i], one) < 1e-13


def test_port_thomas_matches_jax_thomas():
    D, U, b = _problem(np.random.default_rng(12), 23)
    want = jba.block_tridiag_solve(jnp.asarray(D), jnp.asarray(U),
                                   jnp.asarray(b))
    assert rel_err(ba.block_tridiag_solve(T(D), T(U), T(b)), want) < 1e-12


@pytest.mark.parametrize("N", [64, 130, 257])
def test_jacobi_scaled_solve_matches_jax(N):
    rng = np.random.default_rng(100 + N)
    D, U, b = _scaled(rng, *_problem(rng, N))
    want = np.asarray(jba.jacobi_scaled_tridiag_solve(
        jnp.asarray(D), jnp.asarray(U), jnp.asarray(b), variant="thomas"))
    for variant in ("auto", "thomas"):
        got = ba.jacobi_scaled_tridiag_solve(T(D), T(U), T(b),
                                             variant=variant)
        assert rel_err(got, want) < TOL, (N, variant)


def test_wrapper_rejects_bad_shapes():
    D, U, b = _problem(np.random.default_rng(13), 8, B=2)
    with pytest.raises(ValueError):
        tridiag_pcr.block_tridiag_solve_pcr(T(D), T(U[:, :-1]), T(b))
    with pytest.raises(TypeError):
        tridiag_pcr.block_tridiag_solve_pcr(T(D), T(U, torch.float32), T(b))
