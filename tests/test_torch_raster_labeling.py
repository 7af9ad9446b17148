"""PyTorch port vs JAX package: tools/raster.py (affine transforms,
zero-padded window crops) and tools/labeling.py (label geometry, Web
Mercator and UTM projections, YOLO label files, the label overlay).

Both are host code in both packages.  Crops must be equal, padding
included (windows inside, across every edge and wholly outside the
image; the JAX package crops in its C++ runtime where that is built, in
numpy otherwise: the same function);
the projections and label rows within 1e-9 (the same formulas: the
bound only allows a libm or BLAS difference); label files and overlays
equal.
"""
import numpy as np
import pytest

from vinsat_tpu.tools import labeling as jlab
from vinsat_tpu.tools import raster as jraster
from vinsat_tpu_torch.tools import labeling as lab
from vinsat_tpu_torch.tools import raster


BOXES = [(10.2, 50.3, 11.1, 51.2),   # inside
         (9.5, 49.6, 10.4, 50.5),    # across the west and south edges
         (11.7, 51.5, 12.6, 52.4),   # across the east and north edges
         (8.0, 48.0, 14.0, 54.0),    # around the whole image
         (13.0, 53.0, 14.0, 54.0),   # wholly outside
         (10.5, 50.5, 10.5, 51.0),   # empty
         (10.0, 50.0, 12.0, 52.0)]   # exactly the image


def test_get_window_equal():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (200, 200, 3), dtype=np.uint8)
    t = raster.Affine(0.01, 0.0, 10.0, 0.0, -0.01, 52.0)
    tj = jraster.Affine(*t)
    srv, jsrv = raster.RasterImageServer(), jraster.RasterImageServer()
    srv.register("32T", img, t)
    jsrv.register("32T", img, tj)
    assert srv.regions() == ["32T"]
    assert srv.get_window("10S", *BOXES[0]) == (None, None)
    for box in BOXES:
        got, gt = srv.get_window("32T", *box)
        want, wt = jsrv.get_window("32T", *box)
        if want is None:
            assert got is None and gt is None
            continue
        np.testing.assert_array_equal(got, want)
        assert tuple(gt) == tuple(wt)
    full, _ = srv.get_window("32T", *BOXES[-1])
    assert full.shape == (200, 200, 3)
    np.testing.assert_array_equal(full, img)
    pad, _ = srv.get_window("32T", *BOXES[1])
    assert pad.shape == (90, 90, 3) and (pad[-40:] == 0).all() \
        and (pad[:, :50] == 0).all() and (pad[:50, 50:] != 0).any()
    cols = rng.uniform(-50, 250, 20)
    rows = rng.uniform(-50, 250, 20)
    np.testing.assert_allclose(t.pixel_to_world(cols, rows),
                               tj.pixel_to_world(cols, rows), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(t.world_to_pixel(*t.pixel_to_world(cols,
                                                                  rows)),
                               (cols, rows), rtol=0, atol=1e-9)


def _landmarks(rng, n, lon0, lat0, span):
    lon = lon0 + rng.uniform(0, span, n)
    lat = lat0 + rng.uniform(0, span, n)
    half = rng.uniform(0.002, 0.02, (n, 2))
    return np.stack([lon, lat, lon - half[:, 0], lat - half[:, 1],
                     lon + half[:, 0], lat + half[:, 1]], axis=1)


@pytest.mark.parametrize("crs", ["EPSG:3857", "EPSG:4326", "EPSG:32633",
                                 "EPSG:32733"])
def test_label_transforms_equal(crs):
    rng = np.random.default_rng(1)
    north = crs != "EPSG:32733"
    lat0 = 40.0 if north else -45.0
    lm = _landmarks(rng, 60, 13.0, lat0, 2.0)
    proj = lab._parse_crs(crs)
    x0, y0 = proj(np.array([12.9]), np.array([lat0 + 2.1]))
    x1, y1 = proj(np.array([15.1]), np.array([lat0 - 0.1]))
    W, H = 512, 640
    t = raster.Affine((x1[0] - x0[0]) / W, 0.0, x0[0], 0.0,
                      (y1[0] - y0[0]) / H, y0[0])
    got = lab.label_raster(lm, t, W, H, crs=crs)
    want = jlab.label_raster(lm, jraster.Affine(*t), W, H, crs=crs)
    assert got.shape == want.shape and len(got) > 20
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    np.testing.assert_allclose(
        lab.label_grid(lm, 13.0, lat0, 15.0, lat0 + 2.0, W, H),
        jlab.label_grid(lm, 13.0, lat0, 15.0, lat0 + 2.0, W, H),
        rtol=0, atol=1e-9)
    lon, lat = lm[:, 0], lm[:, 1]
    if crs.startswith("EPSG:32"):
        zone = int(crs[-2:])
        e, n = lab.lonlat_to_utm(lon, lat, zone, north)
        ej, nj = jlab.lonlat_to_utm(lon, lat, zone, north)
        np.testing.assert_allclose((e, n), (ej, nj), rtol=0, atol=1e-9)
        np.testing.assert_allclose(lab.utm_to_lonlat(e, n, zone, north),
                                   jlab.utm_to_lonlat(e, n, zone, north),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(lab.utm_to_lonlat(e, n, zone, north),
                                   (lon, lat), rtol=0, atol=1e-9)
    x, y = lab.lonlat_to_epsg3857(lon, lat)
    np.testing.assert_allclose((x, y), jlab.lonlat_to_epsg3857(lon, lat),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(lab.epsg3857_to_lonlat(x, y),
                               jlab.epsg3857_to_lonlat(x, y), rtol=0,
                               atol=1e-9)


def test_label_files_and_overlay_equal(tmp_path):
    rng = np.random.default_rng(2)
    lm = _landmarks(rng, 30, 20.0, 10.0, 1.0)
    rows = lab.label_grid(lm, 20.0, 10.0, 21.0, 11.0, 300, 200)
    path = str(tmp_path / "labels.txt")
    lab.write_yolo_labels(rows, path)
    jpath = str(tmp_path / "labels_jax.txt")
    jlab.write_yolo_labels(rows, jpath)
    assert open(path).read() == open(jpath).read()
    np.testing.assert_array_equal(lab.read_yolo_labels(path),
                                  jlab.read_yolo_labels(jpath))
    img = rng.integers(0, 256, (200, 300), dtype=np.uint8)
    over = lab.visualize_label(path, img)
    np.testing.assert_array_equal(over, jlab.visualize_label(jpath, img))
    assert (over != np.repeat(img[..., None], 3, -1)).any()
    lab.write_ppm(over, str(tmp_path / "a.ppm"))
    jlab.write_ppm(over, str(tmp_path / "b.ppm"))
    assert (open(tmp_path / "a.ppm", "rb").read()
            == open(tmp_path / "b.ppm", "rb").read())
    with pytest.raises(ValueError):
        lab.label_raster(lm, raster.Affine(1, 0, 0, 0, -1, 0), 10, 10,
                         crs="EPSG:2154")
