"""Kernel K3: per-frame count of accepted landmarks inside a footprint box.

Port of vinsat_tpu/kernels/matching.py (visible_count).  The CUDA kernel
is csrc/visible_count.cu (its header says what bounds it on Hopper and what
the design does about it); `visible_count_plain` is its plain PyTorch twin,
the arithmetic of matching.visible_count_reference.

`visible_count` dispatches on the tensors' device: a CPU tensor runs the
plain twin, a CUDA tensor launches the kernel (built from the source at
first use) or raises.  On the card one call is two device kernels: the
tile boxes (`tile_boxes_plain` is their twin), then the count, which skips
every tile whose box no frame of a block can meet.
`visible_count.launches` counts calls that launch the kernel, so a run can
show it went through the kernel.
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


# landmarks per tile, csrc/visible_count.cu's TILE (its entry points check
# the box scratch's size against it)
TILE = 128


def tile_boxes_plain(lon, lat, best):
    """Plain PyTorch twin of the kernel's first launch: per tile of TILE
    landmarks, (lon_min, lon_max, lonw_min, lonw_max, lat_min, lat_max)
    over its accepted landmarks with lonw = lon + 360 in the input's dtype,
    NaN values left out; a tile with none has the empty box (+inf, -inf).
    lon, lat (L,); best (L,) bool -> (ceil(L / TILE), 6)."""
    L = lon.shape[0]
    n = -(-L // TILE)
    cols = torch.stack([lon, lon + 360.0, lat])  # (3, L)
    keep = best & ~cols.isnan()
    inf = float("inf")
    pad = (0, n * TILE - L)
    lo = torch.nn.functional.pad(torch.where(keep, cols, inf), pad,
                                 value=inf)
    hi = torch.nn.functional.pad(torch.where(keep, cols, -inf), pad,
                                 value=-inf)
    mins = lo.view(3, n, TILE).amin(-1)
    maxs = hi.view(3, n, TILE).amax(-1)
    return torch.stack([mins, maxs], dim=-1).permute(1, 0, 2).reshape(n, 6)


_COUNT = _build.Entry("visible_count", "vinsat_visible_count", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_int])
_BOXES = _build.Entry("visible_count", "vinsat_visible_count_tile_boxes", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int])
_FLOATS = (torch.float32, torch.float64)


def _check_landmarks(lon, lat, best):
    L = lon.shape[0]
    if lon.dim() != 1 or lat.shape != (L,) or best.shape != (L,):
        raise ValueError("lon, lat, best must all be (L,)")
    if lon.dtype not in _FLOATS or lat.dtype != lon.dtype:
        raise TypeError("lon, lat must share one dtype, float32 or float64")
    if best.dtype != torch.bool:
        raise TypeError(f"best must be bool, got {best.dtype}")
    if lat.device != lon.device or best.device != lon.device:
        raise ValueError("lon, lat, best must lie on one device")
    return L


def tile_boxes(lon, lat, best):
    """The tile boxes of `tile_boxes_plain` (TILE landmarks a tile): on a
    CUDA tensor from the kernel's first launch alone, on a CPU tensor from
    the twin."""
    L = _check_landmarks(lon, lat, best)
    dev = lon.device
    if dev.type == "cpu":
        return tile_boxes_plain(lon, lat, best)
    if dev.type != "cuda":
        raise ValueError(f"no tile_boxes for device {dev}")
    if not (lon.is_contiguous() and lat.is_contiguous()
            and best.is_contiguous()):
        raise ValueError("tile_boxes kernel needs contiguous inputs")
    n = -(-L // TILE)
    boxes = torch.empty((n, 6), dtype=lon.dtype, device=dev)
    _BOXES(dev, lon.data_ptr(), lat.data_ptr(), best.data_ptr(),
           boxes.data_ptr(), L, n, lon.dtype == torch.float64)
    return boxes


def visible_count(bounds, lon, lat, best):
    """Per-frame count of the landmarks with `best` set strictly inside
    each box.  bounds (F, 4); lon, lat (L,) of the same float dtype (f32 or
    f64); best (L,) bool.  Returns (F,) int32 on the inputs' device."""
    if bounds.dim() != 2 or bounds.shape[1] != 4:
        raise ValueError(f"bounds must be (F, 4), got {tuple(bounds.shape)}")
    L = _check_landmarks(lon, lat, best)
    if bounds.dtype != lon.dtype:
        raise TypeError("bounds, lon, lat must share one dtype, float32 or "
                        "float64")
    dev = bounds.device
    if lon.device != dev:
        raise ValueError("bounds, lon, lat, best must lie on one device")
    if dev.type == "cpu":
        return visible_count_plain(bounds, lon, lat, best)
    if dev.type != "cuda":
        raise ValueError(f"no visible_count for device {dev}")
    if not (bounds.is_contiguous() and lon.is_contiguous()
            and lat.is_contiguous() and best.is_contiguous()):
        raise ValueError("visible_count kernel needs contiguous inputs")
    F, n = bounds.shape[0], -(-L // TILE)
    out = torch.empty(F, dtype=torch.int32, device=dev)
    boxes = torch.empty(n * 6, dtype=lon.dtype, device=dev)
    _COUNT(dev, bounds.data_ptr(), lon.data_ptr(), lat.data_ptr(),
           best.data_ptr(), boxes.data_ptr(), out.data_ptr(), F, L, n,
           lon.dtype == torch.float64)
    visible_count.launches += 1
    return out


visible_count.launches = 0
