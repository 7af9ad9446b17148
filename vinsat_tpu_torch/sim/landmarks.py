"""Landmark database as dense tensors, the visibility tests, the CSV
loader and the detector-QA and saliency downselects (port of
vinsat_tpu/sim/landmarks.py).

  lon, lat   (L,) degrees     centroids
  bbox       (L, 4) degrees   (left_lon, bot_lat, right_lon, top_lat)
  region     (L,) int64       index into mgrs.ZONE_LABELS
  cls        (L,) int64       per-region class id
  best       (L,) bool        class passed detector QA
  saliency   (L,) float64     saliency score

`synthesize` draws on the host with numpy's `default_rng(seed)`, the JAX
package's own generator: given the int that the JAX package derives from
its key, it makes the same database bit for bit.  `load_csv_dir` reads a
VINSat-format CSV directory, `select_best_classes` marks the classes that
pass the reference's detector-QA rule (host numpy, the JAX package's draw
order, so the same masks from the same seed), `load_reference_db`
composes the two, and `downselect_by_saliency` is the per-scale
saliency cut of the labeling stage.
"""
from __future__ import annotations

import csv
import os
from typing import Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch

from vinsat_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from vinsat_tpu_torch.evalx import px_err
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


def _csv_column(rows, *names):
    """The first of `names` that the CSV has, as floats; None if none."""
    for nm in names:
        if rows and nm in rows[0]:
            return np.array([float(x[nm]) for x in rows])
    return None


def load_csv_dir(path: str, regions: Optional[Sequence[str]] = None,
                 best_classes_dir: Optional[str] = None,
                 device=DEFAULT_DEVICE) -> LandmarkDB:
    """Load a VINSat-format landmark CSV directory onto `device`.

    Files are <REGION>_top_salient.csv (all of the directory's, sorted,
    unless `regions` names them) with Centroid Longitude / Latitude and
    the bbox corners spelled "Top-Left Longitude" or "Top Left Longitude"
    (likewise Latitude, Bottom-Right); without corners the bbox is the
    centroid +- 0.01 deg, without a Saliency column the saliency is 0.
    With `best_classes_dir`, a region's <REGION>_best_classes.npy lists its
    accepted class ids (ids past the CSV's rows ignored; a region without
    the file accepts none); without it every class is accepted."""
    if regions is None:
        regions = [f.split("_")[0] for f in sorted(os.listdir(path))
                   if f.endswith("_top_salient.csv")]
    cols = {k: [] for k in _DTYPES}
    for r in regions:
        with open(os.path.join(path, f"{r}_top_salient.csv")) as f:
            rows = list(csv.DictReader(f))
        n = len(rows)
        lon = np.array([float(x["Centroid Longitude"]) for x in rows])
        lat = np.array([float(x["Centroid Latitude"]) for x in rows])
        ll = _csv_column(rows, "Top-Left Longitude", "Top Left Longitude")
        tt = _csv_column(rows, "Top-Left Latitude", "Top Left Latitude")
        rr = _csv_column(rows, "Bottom-Right Longitude",
                         "Bottom Right Longitude")
        bb = _csv_column(rows, "Bottom-Right Latitude",
                         "Bottom Right Latitude")
        if ll is None:
            ll, rr = lon - 0.01, lon + 0.01
            tt, bb = lat + 0.01, lat - 0.01
        sal = _csv_column(rows, "Saliency", "saliency")
        best = np.zeros(n, dtype=bool)
        if best_classes_dir is not None:
            bc = os.path.join(best_classes_dir, f"{r}_best_classes.npy")
            if os.path.exists(bc):
                idx = np.load(bc).astype(int)
                best[idx[idx < n]] = True
        else:
            best[:] = True
        cols["lon"].append(lon)
        cols["lat"].append(lat)
        cols["bbox"].append(np.stack([ll, bb, rr, tt], axis=1))
        cols["region"].append(np.full(n, mgrs.ZONE_INDEX[r]))
        cols["cls"].append(np.arange(n))
        cols["best"].append(best)
        cols["saliency"].append(np.zeros(n) if sal is None else sal)
    return db_from_numpy({k: np.concatenate(v) for k, v in cols.items()},
                         device)


def select_best_classes(db: LandmarkDB, seed: int = 0,
                        samples_per_class: int = 12,
                        px_threshold: float = 10.0,
                        scale_median_px: float = 10.0,
                        scale_sigma: float = 0.6):
    """Detector-QA class downselect over a landmark DB, region by region:
    class k localizes with pixel scale s_k ~ LogNormal(ln scale_median_px,
    scale_sigma) and confidence ~ U(0.5, 1); its [err, conf] records go
    through the reference's selection rule (px_err.best_classes_grid: the
    first confidence threshold maximizing the classes whose median error
    is under px_threshold).  Host numpy, `default_rng(seed)` drawn in the
    JAX package's order, so the same seed gives the same masks.

    Returns (db with the best mask replaced, on db's device,
    {region index: best conf})."""
    rng = np.random.default_rng(seed)
    region = db.region.cpu().numpy()
    cls = db.cls.cpu().numpy()
    best = np.zeros(db.num_landmarks, dtype=bool)
    best_confs = {}
    for r in np.unique(region):
        at = region == r
        n = len(cls[at])
        s_k = np.exp(np.log(scale_median_px)
                     + scale_sigma * rng.standard_normal(n))
        err = np.hypot(
            rng.standard_normal((n, samples_per_class)) * s_k[:, None],
            rng.standard_normal((n, samples_per_class)) * s_k[:, None])
        conf = 0.5 + 0.5 * rng.random((n, samples_per_class))
        keep, bc = px_err.best_classes_grid(err, conf,
                                            px_threshold=px_threshold)
        best_confs[int(r)] = bc
        best[np.nonzero(at)[0][keep]] = True
    return db._replace(best=torch.as_tensor(best, device=db.best.device)), \
        best_confs


def load_reference_db(csv_dir: str, best_downselect: bool = True,
                      seed: int = 0, device=DEFAULT_DEVICE) -> LandmarkDB:
    """`load_csv_dir(csv_dir)`, then (optionally) `select_best_classes`:
    the DB configuration the reference simulator runs with."""
    db = load_csv_dir(csv_dir, device=device)
    if best_downselect:
        db, _ = select_best_classes(db, seed=seed)
    return db


def downselect_by_saliency(saliency: np.ndarray, scales: np.ndarray,
                           num_landmarks: int, scale_values=None):
    """Per-scale saliency percentile cut (the labeling stage's downselect):
    a bool keep-mask over the input landmarks keeping, within each scale,
    those above the (1 - num_landmarks / total) percentile."""
    saliency = np.asarray(saliency)
    scales = np.asarray(scales)
    if scale_values is None:
        scale_values = np.unique(scales)
    tot = sum((scales == s).sum() for s in scale_values)
    thresh = (1 - num_landmarks / tot) * 100
    keep = np.zeros(len(saliency), dtype=bool)
    for s in scale_values:
        at = scales == s
        if not at.any():
            continue
        cut = np.percentile(saliency[at], thresh)
        keep |= at & (saliency > cut)
    return keep
