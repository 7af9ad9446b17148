"""PyTorch port vs JAX package: the landmark DB's CSV loader, the
detector-QA best-class downselect and the saliency downselect.

The CSVs are written by the test from a seed: regions with the hyphenated
and the spaced column spellings, one without bbox columns (the 0.01 deg
default) and without saliency, a best-classes directory holding an array
for some regions (ids past the CSV's rows included) and none for others.
The host numpy is the same in both packages, so every field must be
equal; the port's fields are tensors on the requested device.
"""
import csv

import numpy as np
import pytest

from torch_parity import torch_one_thread  # noqa: F401
from vinsat_tpu.sim import landmarks as jlm
from vinsat_tpu_torch.sim import landmarks as lm

COLS = {
    "hyphen": ["Centroid Longitude", "Centroid Latitude", "Top-Left Longitude",
               "Top-Left Latitude", "Bottom-Right Longitude",
               "Bottom-Right Latitude", "Saliency"],
    "space": ["Centroid Longitude", "Centroid Latitude", "Top Left Longitude",
              "Top Left Latitude", "Bottom Right Longitude",
              "Bottom Right Latitude", "saliency"],
    "bare": ["Centroid Longitude", "Centroid Latitude"],
}


def _write_dir(tmp_path, rng):
    """Three regions' CSVs (one spelling each) and best-class arrays for
    two of them."""
    csv_dir, best_dir = tmp_path / "csv", tmp_path / "best"
    csv_dir.mkdir()
    best_dir.mkdir()
    for region, style, n in (("10S", "hyphen", 37), ("32T", "space", 23),
                             ("54S", "bare", 15)):
        lon = rng.uniform(-120, 140, n)
        lat = rng.uniform(-40, 60, n)
        half = rng.uniform(0.005, 0.05, (n, 2))
        vals = np.stack([lon, lat, lon - half[:, 0], lat + half[:, 1],
                         lon + half[:, 0], lat - half[:, 1],
                         rng.random(n)], axis=1)
        with open(csv_dir / f"{region}_top_salient.csv", "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(COLS[style] + ["Name"])
            for row in vals:
                w.writerow([repr(float(v)) for v in row[:len(COLS[style])]]
                           + ["x"])
        if region != "54S":
            ids = np.concatenate([rng.permutation(n)[:n // 3], [n + 5]])
            np.save(best_dir / f"{region}_best_classes.npy", ids)
    return str(csv_dir), str(best_dir)


def _equal(db, jdb):
    for k in jlm.LandmarkDB._fields:
        got, want = getattr(db, k), np.asarray(getattr(jdb, k))
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want, err_msg=k)


@pytest.mark.parametrize("with_best", [False, True])
def test_load_csv_dir_equal(tmp_path, with_best):
    csv_dir, best_dir = _write_dir(tmp_path, np.random.default_rng(0))
    best = best_dir if with_best else None
    db = lm.load_csv_dir(csv_dir, best_classes_dir=best, device="cpu")
    _equal(db, jlm.load_csv_dir(csv_dir, best_classes_dir=best))
    assert db.num_landmarks == 75
    assert bool(db.best.all()) != with_best
    sub = lm.load_csv_dir(csv_dir, regions=["32T"], device="cpu")
    _equal(sub, jlm.load_csv_dir(csv_dir, regions=["32T"]))
    assert (sub.saliency > 0).all()


def test_select_best_classes_and_reference_db_equal(tmp_path):
    csv_dir, _ = _write_dir(tmp_path, np.random.default_rng(1))
    jdb = jlm.load_csv_dir(csv_dir)
    db = lm.load_csv_dir(csv_dir, device="cpu")
    for seed in (0, 3):
        got, confs = lm.select_best_classes(db, seed=seed)
        want, confs_j = jlm.select_best_classes(jdb, seed=seed)
        _equal(got, want)
        assert confs == confs_j
        assert 0 < int(got.best.sum()) < db.num_landmarks
    _equal(lm.load_reference_db(csv_dir, seed=2, device="cpu"),
           jlm.load_reference_db(csv_dir, seed=2))
    _equal(lm.load_reference_db(csv_dir, best_downselect=False,
                                device="cpu"),
           jlm.load_reference_db(csv_dir, best_downselect=False))


def test_downselect_by_saliency_equal():
    rng = np.random.default_rng(2)
    sal = rng.random(500)
    scales = rng.choice([1, 2, 4, 8], 500)
    for n, values in ((100, None), (40, [2, 8]), (60, [1, 2, 3])):
        keep = lm.downselect_by_saliency(sal, scales, n, values)
        np.testing.assert_array_equal(
            keep, jlm.downselect_by_saliency(sal, scales, n, values))
        assert 0 < keep.sum() <= n + 4


def test_csv_loader_raises_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    csv_dir, _ = _write_dir(tmp_path, np.random.default_rng(3))
    with pytest.raises(RuntimeError):
        lm.load_csv_dir(csv_dir)
