"""PyTorch port vs JAX package: the detector-QA statistics of
evalx/px_err.py (numpy in both packages, so every result must be equal:
the same arithmetic in the same order).

Records are made from a seed: per-image [cls, err_px, conf] rows from
labels and detections with misses and extras, and regular (classes,
samples) error / confidence grids.
"""
import numpy as np
import pytest

from vinsat_tpu.evalx import px_err as jpx
from vinsat_tpu_torch.evalx import px_err


def _records(rng, n_images=6, K=8, W=640, H=480):
    """Error records over a few images through both error_records (each
    image: labels of most classes, detections of most labels with noise,
    an extra detection of an unlabelled class)."""
    out_j, out_t = [], []
    for _ in range(n_images):
        lab = rng.permutation(K)[:K - 2]
        lab_uv = rng.uniform(0.05, 0.95, (len(lab), 2))
        keep = rng.random(len(lab)) < 0.8
        det_cls = np.concatenate([lab[keep], [K + 1]])
        det_uv = np.concatenate([
            lab_uv[keep] + rng.normal(size=(keep.sum(), 2)) * 0.01,
            rng.uniform(0, 1, (1, 2))])
        conf = rng.uniform(0.3, 1.0, len(det_cls))
        args = (lab, lab_uv, det_cls, det_uv, conf, W, H)
        out_j.append(jpx.error_records(*args))
        out_t.append(px_err.error_records(*args))
    return np.concatenate(out_j), np.concatenate(out_t)


def test_error_records_and_class_stats_equal():
    rng = np.random.default_rng(0)
    ej, et = _records(rng)
    np.testing.assert_array_equal(et, ej)
    assert (et[:, 1] == -1).any() and (et[:, 2] == -1).any()
    for c in np.unique(ej[:, 0]):
        for thr in (0.0, 0.5, 0.7):
            np.testing.assert_array_equal(
                np.array(px_err.class_stats(et, c, thr), float),
                np.array(jpx.class_stats(ej, c, thr), float))
    empty = px_err.error_records([], np.zeros((0, 2)), [], np.zeros((0, 2)),
                                 [], 10, 10)
    assert empty.shape == (0, 3)


@pytest.mark.parametrize("px_threshold", [5.0, 10.0])
def test_best_conf_searches_equal(px_threshold):
    rng = np.random.default_rng(1)
    ej, et = _records(rng, n_images=20)
    assert (px_err.best_conf_minimize_error(et)
            == jpx.best_conf_minimize_error(ej))
    got, conf = px_err.best_conf_maximize_classes(et, px_threshold)
    want, conf_j = jpx.best_conf_maximize_classes(ej, px_threshold)
    assert conf == conf_j
    np.testing.assert_array_equal(got, want)
    s, s_j = px_err.summarize_detector(et, px_threshold), \
        jpx.summarize_detector(ej, px_threshold)
    assert s.keys() == s_j.keys()
    for k in s:
        assert s[k] == s_j[k] or (np.isnan(s[k]) and np.isnan(s_j[k]))


def test_best_classes_grid_equal():
    rng = np.random.default_rng(2)
    n, S = 40, 12
    scale = np.exp(np.log(10.0) + 0.6 * rng.standard_normal(n))
    err = np.hypot(rng.standard_normal((n, S)) * scale[:, None],
                   rng.standard_normal((n, S)) * scale[:, None])
    err[rng.random((n, S)) < 0.05] = -1.0
    conf = 0.5 + 0.5 * rng.random((n, S))
    for thr in (3.0, 10.0):
        keep, bc = px_err.best_classes_grid(err, conf, px_threshold=thr)
        keep_j, bc_j = jpx.best_classes_grid(err, conf, px_threshold=thr)
        np.testing.assert_array_equal(keep, keep_j)
        assert bc == bc_j
    keep, bc = px_err.best_classes_grid(err, conf, px_threshold=0.0)
    assert not keep.any() and bc == 0.0
