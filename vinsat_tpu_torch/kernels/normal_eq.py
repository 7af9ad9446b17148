"""Kernel K2: robust-weighted normal-equation assembly per knot.

Port of vinsat_tpu/kernels/normal_eq.py (assemble_normal_eq).  The CUDA
kernel is csrc/normal_eq.cu (its header says what bounds it on Hopper and
what the design does about it); `assemble_normal_eq_plain` is its plain
PyTorch twin, the arithmetic of normal_eq.assemble_normal_eq_reference.

`assemble_normal_eq` dispatches on the tensors' device: a CPU tensor runs
the plain twin, a CUDA tensor launches the kernel (built from the source at
first use) or raises.  It assembles in the inputs' dtype; `f32=True` keeps
the TPU kernel's contract (inputs rounded to f32, f32 sums, the result in
the inputs' dtype), which the kernel does in its one launch.
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


_ENTRY = _build.Entry("normal_eq", "vinsat_normal_eq", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int])
_FLOATS = (torch.float32, torch.float64)


def assemble_normal_eq(J, r, w, f32: bool = False):
    """Fused JᵀWJ + JᵀWr for per-knot observation budgets.  J (N, D, 2, 9);
    r (N, D, 2) residuals; w (N, D) weights (0 for invalid slots), all of
    one float dtype (f32 or f64) on one device.  Returns (G (N, 9, 9),
    g (N, 9)) in that dtype; with f32=True the sums run in f32.  On the
    card G and g are views of one buffer, each contiguous."""
    shape = J.shape
    if len(shape) != 4 or shape[2] != 2 or shape[3] != 9:
        raise ValueError(f"J must be (N, D, 2, 9), got {tuple(shape)}")
    N, D = shape[0], shape[1]
    if r.shape != (N, D, 2) or w.shape != (N, D):
        raise ValueError(f"r must be (N, D, 2) and w (N, D) for J "
                         f"{tuple(shape)}, got {tuple(r.shape)}, "
                         f"{tuple(w.shape)}")
    dtype = J.dtype
    if dtype not in _FLOATS or r.dtype is not dtype or w.dtype is not dtype:
        raise TypeError("J, r, w must share one dtype, float32 or float64")
    dev = J.device
    if r.device != dev or w.device != dev:
        raise ValueError("J, r, w must lie on one device")
    if not J.is_cuda:
        if dev.type == "cpu":
            return assemble_normal_eq_plain(J, r, w, f32=f32)
        raise ValueError(f"no normal_eq for device {dev}")
    if not (J.is_contiguous() and r.is_contiguous() and w.is_contiguous()):
        raise ValueError("normal_eq kernel needs contiguous inputs")
    # G then g in one buffer (as_strided is the cheapest pair of views)
    out = J.new_empty(N * 90)
    ptr = out.data_ptr()
    _ENTRY(dev, J.data_ptr(), r.data_ptr(), w.data_ptr(), ptr,
           ptr + N * 81 * J.element_size(), N, D, dtype is torch.float64,
           f32)
    assemble_normal_eq.launches += 1
    return (out.as_strided((N, 9, 9), (81, 9, 1)),
            out.as_strided((N, 9), (9, 1), N * 81))


assemble_normal_eq.launches = 0
