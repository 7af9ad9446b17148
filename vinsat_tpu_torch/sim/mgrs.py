"""MGRS 6°x8° grid-zone table (port of vinsat_tpu/sim/mgrs.py).

The table is numpy constants, copied from the JAX module: regular zones
01C..60W, the X band (72..84) and the Norway / Svalbard special zones.
Zone lookup is a vectorised interval test on torch tensors.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from vinsat_tpu_torch.config import DEFAULT_DEVICE, resolve_device

LON_STEP = 6
LAT_STEP = 8
_LAT_LABELS = ["C", "D", "E", "F", "G", "H", "J", "K", "L", "M",
               "N", "P", "Q", "R", "S", "T", "U", "V", "W", "X"]


def mgrs_grid() -> Dict[str, Tuple[float, float, float, float]]:
    """Zone label -> (lon_min, lat_min, lon_max, lat_max) degrees."""
    lons = np.arange(-180, 180, LON_STEP)
    lats = np.arange(-80, 80, LAT_STEP)
    grid: Dict[str, Tuple[float, float, float, float]] = {}
    for i, lat in enumerate(lats):
        for j, lon in enumerate(lons):
            grid[str(j + 1).zfill(2) + _LAT_LABELS[i]] = (
                float(lon), float(lat), float(lon + LON_STEP),
                float(lat + LAT_STEP))
    for j in range(1, 61):
        grid[str(j).zfill(2) + "X"] = (
            float(lons[j - 1]), 72.0, float(lons[j - 1] + LON_STEP), 84.0)
    grid["31V"] = (0.0, 56.0, 3.0, 64.0)
    grid["32V"] = (3.0, 56.0, 12.0, 64.0)
    grid["31X"] = (0.0, 72.0, 9.0, 84.0)
    grid["33X"] = (9.0, 72.0, 21.0, 84.0)
    grid["35X"] = (21.0, 72.0, 33.0, 84.0)
    grid["37X"] = (33.0, 72.0, 42.0, 84.0)
    for dead in ("32X", "34X", "36X"):
        del grid[dead]
    return grid


_GRID = mgrs_grid()
ZONE_LABELS: List[str] = list(_GRID.keys())
ZONE_BOUNDS = np.array([_GRID[k] for k in ZONE_LABELS])  # (Z, 4)
ZONE_INDEX = {k: i for i, k in enumerate(ZONE_LABELS)}

# The 16 regions with trained detectors in the reference
ACTIVE_REGIONS = ["10S", "10T", "11R", "12R", "16T", "17R", "17T", "18S",
                  "32S", "32T", "33S", "33T", "52S", "53S", "54S", "54T"]


def zone_of(lon_deg, lat_deg):
    """Zone index into ZONE_LABELS of each (lon, lat) tensor entry, -1 where
    no zone holds it; a point on a shared edge takes the first zone in
    table order (as argmax picks it)."""
    lon, lat = lon_deg[..., None], lat_deg[..., None]
    b = torch.as_tensor(ZONE_BOUNDS, dtype=lon_deg.dtype,
                        device=lon_deg.device)
    inside = ((b[:, 0] <= lon) & (lon <= b[:, 2])
              & (b[:, 1] <= lat) & (lat <= b[:, 3]))
    idx = torch.argmax(inside.to(torch.int32), dim=-1)
    return torch.where(inside.any(dim=-1), idx, torch.full_like(idx, -1))


def active_region_mask(device=DEFAULT_DEVICE) -> torch.Tensor:
    """(Z,) bool mask of the 16 detector-active regions on `device`."""
    mask = np.zeros(len(ZONE_LABELS), dtype=bool)
    mask[[ZONE_INDEX[r] for r in ACTIVE_REGIONS]] = True
    return torch.as_tensor(mask, device=resolve_device(device))
