"""The port's CUDA kernels on the card (marker `cuda`; they skip without
one).  No JAX here, so on a machine with a GPU and no JAX this file runs
alone:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

K1 against its plain PyTorch twin on the same tensors: relative 1e-9 in
f64, 1e-4 in f32 (pivot-free elimination on Jacobi-scaled blocks; f32
roundoff over ~9 levels).  One BA iteration on the card (kernel path)
against the CPU (plain path): states relative 1e-9 (the two differ in
summation order, and index_add_ sums with atomics on the card); the trial
residual mean 1e-8, since it weighs differences of ~7000 km positions by
sqrt(Σ) (tests/test_torch_ba.py).
"""
import numpy as np
import pytest
import torch

from vinsat_tpu_torch.estimation import ba
from vinsat_tpu_torch.kernels import tridiag_pcr


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _problem(rng, B, N, k=9):
    A = rng.normal(size=(B, N, k, k)) * 0.1
    D = np.einsum("btij,btkj->btik", A, A) + np.eye(k) * 3.0
    U = rng.normal(size=(B, N - 1, k, k)) * 0.05
    b = rng.normal(size=(B, N, k))
    return D, U, b


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("N", [1, 5, 64, 257, 448])
def test_kernel_matches_plain(N, dtype, tol):
    dev = _cuda()
    D, U, b = (torch.as_tensor(a, dtype=dtype, device=dev)
               for a in _problem(np.random.default_rng(N), 9, N))
    before = tridiag_pcr.block_tridiag_solve_pcr.launches
    got = tridiag_pcr.block_tridiag_solve_pcr(D, U, b)
    torch.cuda.synchronize()
    assert tridiag_pcr.block_tridiag_solve_pcr.launches == before + 1
    assert _rel(got, tridiag_pcr.block_tridiag_solve_pcr_plain(D, U, b)) < tol


@pytest.mark.cuda
def test_kernel_shared_u_matches_batched_u():
    dev = _cuda()
    D, U, b = (torch.as_tensor(a, device=dev)
               for a in _problem(np.random.default_rng(3), 4, 100))
    shared = tridiag_pcr.block_tridiag_solve_pcr(D, U[0].contiguous(), b)
    batched = tridiag_pcr.block_tridiag_solve_pcr(
        D, U[0].expand(4, -1, -1, -1).contiguous(), b)
    assert _rel(shared, batched) == 0.0


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous():
    dev = _cuda()
    D, U, b = (torch.as_tensor(a, device=dev)
               for a in _problem(np.random.default_rng(4), 2, 8))
    with pytest.raises(ValueError):
        tridiag_pcr.block_tridiag_solve_pcr(D.transpose(-1, -2), U, b)


@pytest.mark.cuda
def test_ba_iteration_on_card_matches_cpu():
    dev = _cuda()
    rng = np.random.default_rng(5)
    N, M = 64, 448
    pos = rng.normal(size=(N, 3)) * 30 + np.array([6900.0, 0, 0])
    q = rng.normal(size=(N, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    vel = rng.normal(size=(N, 3)) * 0.1 + np.array([0, 7.5, 0])
    states = np.concatenate([pos, q, vel], axis=1)
    gaps = np.full(N, 120.0)
    gaps[-1] = 0.0
    cum = np.zeros((N, 4))
    cum[:, 3] = 1.0
    fields = dict(
        gaps=gaps, cum_rot=cum,
        landmarks_xyz=pos[rng.integers(0, N, M)] * 0.92,
        landmarks_uv=rng.uniform(0, 2000, size=(M, 2)),
        conf=rng.uniform(0.8, 1.0, M),
        ii=np.sort(rng.integers(0, N, M)), obs_valid=np.ones(M),
        knot_valid=np.ones(N), pair_valid=np.ones(N - 1),
        intrinsics=np.array([3547.85, 3547.85, 2304.0, 1296.0]))
    params = ba.SolverParams(batched_lambda=9, num_hops=2)
    out = {}
    for d in ("cpu", dev):
        out[str(d)] = ba.ba_iteration(
            3, torch.as_tensor(states, device=d),
            ba.problem_from_numpy(fields, d), 1e-4, params=params)
    cpu, gpu = out["cpu"], out[str(dev)]
    assert float(cpu.lamda_init) == float(gpu.lamda_init)
    assert _rel(gpu.states.cpu(), cpu.states) < 1e-9
    assert _rel(gpu.mean_residual.cpu(), cpu.mean_residual) < 1e-8
