"""Kernel K2: robust-weighted normal-equation assembly per knot.

Port of vinsat_tpu/kernels/normal_eq.py (assemble_normal_eq).  The CUDA
kernel is csrc/normal_eq.cu (its header says what bounds it on Hopper and
what the design does about it); `assemble_normal_eq_plain` is its plain
PyTorch twin, the arithmetic of normal_eq.assemble_normal_eq_reference.

`assemble_normal_eq` dispatches on the tensors' device: a CPU tensor runs
the plain twin, a CUDA tensor launches the kernel (built from the source at
first use) or raises.  It assembles in the inputs' dtype; `f32=True` keeps
the TPU kernel's contract (inputs cast to f32, the result cast back).
`assemble_normal_eq.launches` counts kernel launches, so a run can show it
went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from vinsat_tpu_torch.kernels import _build


def assemble_normal_eq_plain(J, r, w, f32: bool = False):
    """Plain PyTorch G = Σ w JᵀJ, g = Σ w Jᵀr per knot.  J (N, D, 2, 9);
    r (N, D, 2); w (N, D) -> (G (N, 9, 9), g (N, 9))."""
    dtype = J.dtype
    if f32:
        J, r, w = J.float(), r.float(), w.float()
    JW = J * w[..., None, None]
    G = torch.einsum("ndki,ndkj->nij", JW, J)
    g = torch.einsum("ndki,ndk->ni", JW, r)
    return G.to(dtype), g.to(dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("normal_eq")
    if lib.vinsat_normal_eq.argtypes is None:
        lib.vinsat_normal_eq.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.vinsat_normal_eq.restype = ctypes.c_int
    return lib


def _launch(J, r, w):
    N, D = J.shape[0], J.shape[1]
    lib = _lib()
    G = torch.empty((N, 9, 9), dtype=J.dtype, device=J.device)
    g = torch.empty((N, 9), dtype=J.dtype, device=J.device)
    with torch.cuda.device(J.device):
        stream = torch.cuda.current_stream(J.device).cuda_stream
        rc = lib.vinsat_normal_eq(
            J.data_ptr(), r.data_ptr(), w.data_ptr(), G.data_ptr(),
            g.data_ptr(), N, D, int(J.dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(f"normal_eq kernel launch failed: CUDA error {rc}")
    assemble_normal_eq.launches += 1
    return G, g


def assemble_normal_eq(J, r, w, f32: bool = False):
    """Fused JᵀWJ + JᵀWr for per-knot observation budgets.  J (N, D, 2, 9);
    r (N, D, 2) residuals; w (N, D) weights (0 for invalid slots), all of
    one float dtype (f32 or f64) on one device.  Returns (G (N, 9, 9),
    g (N, 9)) in that dtype; with f32=True the sums run in f32."""
    if J.dim() != 4 or J.shape[2:] != (2, 9):
        raise ValueError(f"J must be (N, D, 2, 9), got {tuple(J.shape)}")
    N, D = J.shape[0], J.shape[1]
    if r.shape != (N, D, 2) or w.shape != (N, D):
        raise ValueError(f"r must be (N, D, 2) and w (N, D) for J "
                         f"{tuple(J.shape)}, got {tuple(r.shape)}, "
                         f"{tuple(w.shape)}")
    if J.dtype not in (torch.float32, torch.float64) or not (
            r.dtype == w.dtype == J.dtype):
        raise TypeError("J, r, w must share one dtype, float32 or float64")
    if not (r.device == w.device == J.device):
        raise ValueError("J, r, w must lie on one device")
    if J.device.type == "cpu":
        return assemble_normal_eq_plain(J, r, w, f32=f32)
    if J.device.type == "cuda":
        if not all(t.is_contiguous() for t in (J, r, w)):
            raise ValueError("normal_eq kernel needs contiguous inputs")
        if f32 and J.dtype == torch.float64:
            G, g = _launch(J.float(), r.float(), w.float())
            return G.double(), g.double()
        return _launch(J, r, w)
    raise ValueError(f"no normal_eq for device {J.device}")


assemble_normal_eq.launches = 0
