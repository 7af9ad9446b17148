"""Detection-to-landmark matching (port of the plain part of
vinsat_tpu/kernels/matching.py).

`nearest_landmark` is plain array code in the JAX package too, not a TPU
kernel, so it is plain PyTorch here.  The landmark visibility count of the
same JAX module, a TPU kernel, is kernel K3 (kernels/visible_count.py).
"""
from __future__ import annotations

import torch

# DB landmarks a tile, the JAX package's default: the tie-breaking rule
# below depends on it
TILE = 512


def nearest_landmark(lonlat_query, lon_db, lat_db):
    """For each query (Q, 2) [lon, lat] the DB landmark (L,) at the least
    squared lon/lat distance: (idx (Q,) int64, d2 (Q,)).  The DB is read
    in tiles of TILE; within a tile the first least index wins
    (`argmin`), across tiles only a strictly smaller distance replaces the
    best, so ties break toward the lower index as in the JAX package."""
    q = lonlat_query
    d2_best = torch.full((q.shape[0],), float("inf"), dtype=q.dtype,
                         device=q.device)
    idx_best = torch.zeros((q.shape[0],), dtype=torch.int64, device=q.device)
    L = lon_db.shape[0]
    for lo in range(0, L, TILE):
        hi = min(L, lo + TILE)
        dlon = q[:, 0:1] - lon_db[None, lo:hi]
        dlat = q[:, 1:2] - lat_db[None, lo:hi]
        d2 = dlon * dlon + dlat * dlat
        tile_min, tile_arg = d2.amin(dim=1), d2.argmin(dim=1)
        upd = tile_min < d2_best
        d2_best = torch.where(upd, tile_min, d2_best)
        idx_best = torch.where(upd, tile_arg + lo, idx_best)
    return idx_best, d2_best
