"""Landmark database as dense tensors, and the visibility tests (port of
vinsat_tpu/sim/landmarks.py without the CSV readers and the detector-QA
downselect).

  lon, lat   (L,) degrees     centroids
  bbox       (L, 4) degrees   (left_lon, bot_lat, right_lon, top_lat)
  region     (L,) int64       index into mgrs.ZONE_LABELS
  cls        (L,) int64       per-region class id
  best       (L,) bool        class passed detector QA
  saliency   (L,) float64     saliency score

`synthesize` draws on the host with numpy's `default_rng(seed)`, the JAX
package's own generator: given the int that the JAX package derives from
its key, it makes the same database bit for bit.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch

from vinsat_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from vinsat_tpu_torch.sim import mgrs


class LandmarkDB(NamedTuple):
    lon: torch.Tensor
    lat: torch.Tensor
    bbox: torch.Tensor
    region: torch.Tensor
    cls: torch.Tensor
    best: torch.Tensor
    saliency: torch.Tensor

    @property
    def num_landmarks(self) -> int:
        return self.lon.shape[0]


_DTYPES = dict(lon=torch.float64, lat=torch.float64, bbox=torch.float64,
               region=torch.int64, cls=torch.int64, best=torch.bool,
               saliency=torch.float64)


def db_from_numpy(fields, device=DEFAULT_DEVICE) -> LandmarkDB:
    """A LandmarkDB on `device` from host arrays: a mapping of the seven
    field names (or a named tuple with them, e.g. the JAX package's
    LandmarkDB converted with np.asarray) to arrays."""
    device = resolve_device(device)
    if not isinstance(fields, Mapping):
        fields = fields._asdict()
    return LandmarkDB(**{
        k: torch.as_tensor(np.array(fields[k]), dtype=dt, device=device)
        for k, dt in _DTYPES.items()})


def synthesize(seed: int, regions: Optional[Sequence[str]] = None,
               per_region: int = 495, best_fraction: float = 0.2,
               device=DEFAULT_DEVICE) -> LandmarkDB:
    """A synthetic landmark DB over the given MGRS regions (default the 16
    detector-active ones): `per_region` landmarks uniform in each region's
    box, a `best_fraction` subset detector-accepted, bbox half-sizes of
    0.005-0.05 deg.  Host numpy, `default_rng(seed)`."""
    if regions is None:
        regions = mgrs.ACTIVE_REGIONS
    rng = np.random.default_rng(seed)
    cols = {k: [] for k in _DTYPES}
    for r in regions:
        b = mgrs.ZONE_BOUNDS[mgrs.ZONE_INDEX[r]]
        lon = b[0] + (b[2] - b[0]) * rng.random(per_region)
        lat = b[1] + (b[3] - b[1]) * rng.random(per_region)
        sal = rng.random(per_region)
        nbest = max(1, int(per_region * best_fraction))
        best = np.zeros(per_region, dtype=bool)
        best[rng.permutation(per_region)[:nbest]] = True
        half = 0.005 + 0.045 * rng.random((per_region, 2))
        cols["bbox"].append(np.stack([lon - half[:, 0], lat - half[:, 1],
                                      lon + half[:, 0], lat + half[:, 1]],
                                     axis=1))
        cols["lon"].append(lon)
        cols["lat"].append(lat)
        cols["region"].append(np.full(per_region, mgrs.ZONE_INDEX[r]))
        cols["cls"].append(np.arange(per_region))
        cols["best"].append(best)
        cols["saliency"].append(sal)
    return db_from_numpy({k: np.concatenate(v) for k, v in cols.items()},
                         device)


def in_bounds_mask(db: LandmarkDB, bounds):
    """(..., L) mask of landmarks with the centroid strictly inside the
    boxes bounds (..., 4) = (lon_min, lat_min, lon_max, lat_max).  Each
    landmark is tested at lon and lon + 360, for boxes that wrap the
    antimeridian (camera.footprint_bounds)."""
    lon_min, lat_min = bounds[..., 0:1], bounds[..., 1:2]
    lon_max, lat_max = bounds[..., 2:3], bounds[..., 3:4]
    lon_lift = db.lon + 360.0
    in_lon = ((db.lon > lon_min) & (db.lon < lon_max)) | (
        (lon_lift > lon_min) & (lon_lift < lon_max))
    return in_lon & (db.lat > lat_min) & (db.lat < lat_max)


def visible_best_count(db: LandmarkDB, bounds, region_active_mask=None):
    """Number of detector-accepted landmarks (in active regions, if a mask
    is given) in each footprint box; the imaging gate is count >= 3."""
    m = in_bounds_mask(db, bounds) & db.best
    if region_active_mask is not None:
        m = m & region_active_mask[db.region]
    return m.sum(dim=-1)
