"""Kernel K3: per-frame count of accepted landmarks inside a footprint box.

Port of vinsat_tpu/kernels/matching.py (visible_count).  The CUDA kernel
is csrc/visible_count.cu (its header says what bounds it on Hopper and what
the design does about it); `visible_count_plain` is its plain PyTorch twin,
the arithmetic of matching.visible_count_reference.

`visible_count` dispatches on the tensors' device: a CPU tensor runs the
plain twin, a CUDA tensor launches the kernel (built from the source at
first use) or raises.  `visible_count.launches` counts kernel launches, so
a run can show it went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from vinsat_tpu_torch.kernels import _build


def visible_count_plain(bounds, lon, lat, best):
    """Plain PyTorch count.  bounds (F, 4) (lon_min, lat_min, lon_max,
    lat_max); lon, lat (L,); best (L,) bool -> (F,) int32.  Strict
    comparisons; each landmark is tested at lon and lon + 360, for boxes
    that wrap the antimeridian; a NaN bound compares false."""
    lon_min, lat_min = bounds[:, 0:1], bounds[:, 1:2]
    lon_max, lat_max = bounds[:, 2:3], bounds[:, 3:4]
    lon_l = lon + 360.0
    in_lon = ((lon > lon_min) & (lon < lon_max)) | (
        (lon_l > lon_min) & (lon_l < lon_max))
    inside = in_lon & (lat > lat_min) & (lat < lat_max) & best
    return inside.sum(dim=1, dtype=torch.int32)


def _lib() -> ctypes.CDLL:
    lib = _build.load("visible_count")
    if lib.vinsat_visible_count.argtypes is None:
        lib.vinsat_visible_count.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.vinsat_visible_count.restype = ctypes.c_int
    return lib


def _launch(bounds, lon, lat, best):
    F, L = bounds.shape[0], lon.shape[0]
    lib = _lib()
    out = torch.empty(F, dtype=torch.int32, device=bounds.device)
    with torch.cuda.device(bounds.device):
        stream = torch.cuda.current_stream(bounds.device).cuda_stream
        rc = lib.vinsat_visible_count(
            bounds.data_ptr(), lon.data_ptr(), lat.data_ptr(),
            best.data_ptr(), out.data_ptr(), F, L,
            int(bounds.dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(
            f"visible_count kernel launch failed: CUDA error {rc}")
    visible_count.launches += 1
    return out


def visible_count(bounds, lon, lat, best):
    """Per-frame count of the landmarks with `best` set strictly inside
    each box.  bounds (F, 4); lon, lat (L,) of the same float dtype (f32 or
    f64); best (L,) bool.  Returns (F,) int32 on the inputs' device."""
    if bounds.dim() != 2 or bounds.shape[1] != 4:
        raise ValueError(f"bounds must be (F, 4), got {tuple(bounds.shape)}")
    L = lon.shape[0]
    if lon.dim() != 1 or lat.shape != (L,) or best.shape != (L,):
        raise ValueError("lon, lat, best must all be (L,)")
    if bounds.dtype not in (torch.float32, torch.float64) or not (
            lon.dtype == lat.dtype == bounds.dtype):
        raise TypeError("bounds, lon, lat must share one dtype, float32 or "
                        "float64")
    if best.dtype != torch.bool:
        raise TypeError(f"best must be bool, got {best.dtype}")
    if not (lon.device == lat.device == best.device == bounds.device):
        raise ValueError("bounds, lon, lat, best must lie on one device")
    if bounds.device.type == "cpu":
        return visible_count_plain(bounds, lon, lat, best)
    if bounds.device.type == "cuda":
        if not all(t.is_contiguous() for t in (bounds, lon, lat, best)):
            raise ValueError("visible_count kernel needs contiguous inputs")
        return _launch(bounds, lon, lat, best)
    raise ValueError(f"no visible_count for device {bounds.device}")


visible_count.launches = 0
