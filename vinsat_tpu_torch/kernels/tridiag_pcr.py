"""Kernel K1: batched block-tridiagonal solve by parallel cyclic reduction.

Port of vinsat_tpu/kernels/tridiag_pallas.py (block_tridiag_solve_pallas).
The CUDA kernel is csrc/tridiag_pcr.cu (its header says what bounds it on
Hopper and what the design does about it); `block_tridiag_solve_pcr_plain`
is its plain PyTorch twin with the same levels and elimination order.

`block_tridiag_solve_pcr` dispatches on the tensors' device: a CPU tensor
runs the plain twin, a CUDA tensor launches the kernel (built from the
source at first use) or raises.  `block_tridiag_solve_pcr.launches` counts
kernel launches (solves), so a run can show it went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from vinsat_tpu_torch.estimation.ba import gj_solve_small
from vinsat_tpu_torch.kernels import _build

K = 9


def _down(X, s: int):
    """Row i gets X[:, i - s]; zero for i < s."""
    return torch.cat([torch.zeros_like(X[:, :s]), X[:, :-s]], dim=1)


def _up(X, s: int):
    """Row i gets X[:, i + s]; zero for i >= N - s."""
    return torch.cat([X[:, s:], torch.zeros_like(X[:, :s])], dim=1)


def block_tridiag_solve_pcr_plain(D, U, b):
    """Plain PyTorch PCR.  D (B, N, k, k); U (B, N-1, k, k) or (N-1, k, k)
    shared over B; b (B, N, k) -> x (B, N, k).  Solves
    L_i x_{i-1} + D_i x_i + U_i x_{i+1} = b_i with L_i = U_{i-1}^T."""
    Bn, N, k, _ = D.shape
    U = U.expand(Bn, N - 1, k, k)
    z = D.new_zeros(Bn, 1, k, k)
    Uw = torch.cat([U, z], dim=1)
    Lw = torch.cat([z, U.transpose(-1, -2)], dim=1)
    Dw, bw = D, b[..., None]
    s = 1
    while s < N:
        P = gj_solve_small(Dw, torch.cat([Lw, Uw, bw], dim=-1))
        PL, PU, Pb = P[..., :k], P[..., k:2 * k], P[..., 2 * k:]
        Dw = Dw - Lw @ _down(PU, s) - Uw @ _up(PL, s)
        bw = bw - Lw @ _down(Pb, s) - Uw @ _up(Pb, s)
        Lw, Uw = -(Lw @ _down(PL, s)), -(Uw @ _up(PU, s))
        s *= 2
    return gj_solve_small(Dw, bw)[..., 0]


def _lib() -> ctypes.CDLL:
    lib = _build.load("tridiag_pcr")
    if lib.vinsat_tridiag_pcr.argtypes is None:
        lib.vinsat_tridiag_pcr.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.vinsat_tridiag_pcr.restype = ctypes.c_int
        lib.vinsat_tridiag_pcr_work_elems.argtypes = [ctypes.c_longlong,
                                                      ctypes.c_longlong]
        lib.vinsat_tridiag_pcr_work_elems.restype = ctypes.c_longlong
    return lib


def _launch(D, U, b):
    Bn, N = D.shape[0], D.shape[1]
    lib = _lib()
    x = torch.empty_like(b)
    work = torch.empty(lib.vinsat_tridiag_pcr_work_elems(Bn, N),
                       dtype=D.dtype, device=D.device)
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream(D.device).cuda_stream
        rc = lib.vinsat_tridiag_pcr(
            D.data_ptr(), U.data_ptr(), b.data_ptr(), x.data_ptr(),
            work.data_ptr(), Bn, N, int(U.dim() == 4),
            int(D.dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(f"tridiag_pcr kernel launch failed: CUDA error {rc}")
    block_tridiag_solve_pcr.launches += 1
    return x


def block_tridiag_solve_pcr(D, U, b):
    """Solve the symmetric block-tridiagonal system(s).

    D (B, N, 9, 9); U (B, N-1, 9, 9), or (N-1, 9, 9) shared over the batch;
    b (B, N, 9) -> x (B, N, 9).  Unbatched (N, 9, 9) / (N-1, 9, 9) / (N, 9)
    inputs return (N, 9).  f32 or f64, contiguous, one device.  Jacobi-scale
    first (ba.jacobi_scaled_tridiag_solve does): the elimination is pivot
    free.
    """
    unbatched = D.dim() == 3
    if unbatched:
        D, b = D[None], b[None]
    if D.dim() != 4 or D.shape[-2:] != (K, K):
        raise ValueError(f"D must be (B, N, {K}, {K}), got {tuple(D.shape)}")
    Bn, N = D.shape[0], D.shape[1]
    if b.shape != (Bn, N, K):
        raise ValueError(f"b must be {(Bn, N, K)}, got {tuple(b.shape)}")
    if U.shape not in ((Bn, N - 1, K, K), (N - 1, K, K)):
        raise ValueError(f"U must be (B, N-1, {K}, {K}) or (N-1, {K}, {K}),"
                         f" got {tuple(U.shape)}")
    if D.dtype not in (torch.float32, torch.float64) or not (
            U.dtype == b.dtype == D.dtype):
        raise TypeError("D, U, b must share one dtype, float32 or float64")
    if not (U.device == b.device == D.device):
        raise ValueError("D, U, b must lie on one device")
    if D.device.type == "cpu":
        x = block_tridiag_solve_pcr_plain(D, U, b)
    elif D.device.type == "cuda":
        if not (D.is_contiguous() and U.is_contiguous()
                and b.is_contiguous()):
            raise ValueError("tridiag_pcr kernel needs contiguous D, U, b")
        x = _launch(D, U, b)
    else:
        raise ValueError(f"no tridiag_pcr for device {D.device}")
    return x[0] if unbatched else x


block_tridiag_solve_pcr.launches = 0
