"""Detector-quality evaluation: pixel-error stats, class selection, best-conf
search (the port's own numpy copy of vinsat_tpu/evalx/px_err.py).

Functional surface of eval/eval_landmarks.py operating on error records
[cls, err_px, conf] (calculate_error, eval_landmarks.py:123-169): per-class
stats (:211-233), confidence-threshold searches (:235-286).  -1 sentinel
semantics preserved: err=-1 marks an unmatched (extra) detection, conf=-1 a
missed label.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def error_records(label_cls, label_uv, det_cls, det_uv, det_conf,
                  im_w: float, im_h: float) -> np.ndarray:
    """Build [cls, err_px, conf] records for one image.

    label_uv / det_uv in normalized (xc, yc); matches by class id like
    calculate_error (eval_landmarks.py:134-164).
    """
    recs = []
    label_cls = np.asarray(label_cls)
    det_cls = np.asarray(det_cls)
    for c, uv, conf in zip(det_cls, np.asarray(det_uv), np.asarray(det_conf)):
        hit = np.where(label_cls == c)[0]
        if len(hit) > 0:
            lx, ly = np.asarray(label_uv)[hit[0]]
            err = float(np.hypot((uv[0] - lx) * im_w, (uv[1] - ly) * im_h))
            recs.append([int(c), err, float(conf)])
        else:
            recs.append([int(c), -1.0, float(conf)])
    for c in label_cls:
        if c not in det_cls:
            recs.append([int(c), -1.0, -1.0])
    return np.array(recs) if recs else np.zeros((0, 3))


def class_stats(err: np.ndarray, cl: int, conf_threshold: float = 0.5
                ) -> Tuple[int, float, float, float, int, int]:
    """(cls, mean_err, median_err, mean_conf, missed, extra)
    (calculate_class_stats, eval_landmarks.py:211-233)."""
    cl_errs = err[err[:, 0] == cl]
    cl_errs = cl_errs[cl_errs[:, -1] > conf_threshold]
    pos = cl_errs[cl_errs[:, 1] > 0]
    mean_err = float(np.nanmean(pos[:, 1])) if len(pos) else float("nan")
    med_err = float(np.nanmedian(pos[:, 1])) if len(pos) else float("nan")
    mean_conf = float(np.nanmean(pos[:, 2])) if len(pos) else float("nan")
    missed = int((cl_errs[:, 2] == -1).sum())
    extra = int((cl_errs[:, 1] == -1).sum())
    return cl, mean_err, med_err, mean_conf, missed, extra


def best_conf_minimize_error(err: np.ndarray, min_conf: float = 0.5,
                             max_conf: float = 0.8, steps: int = 20) -> float:
    """Confidence threshold minimizing mean matched error
    (get_best_conf, eval_landmarks.py:235-257)."""
    best_err, best_conf = float("inf"), 0.0
    for conf in np.linspace(min_conf, max_conf, steps):
        sel = err[err[:, -1] > conf]
        pos = sel[sel[:, 1] > 0]
        if len(pos) == 0:
            continue
        m = float(pos[:, 1].mean())
        if m < best_err:
            best_err, best_conf = m, float(conf)
    return best_conf


def best_conf_maximize_classes(err: np.ndarray, px_threshold: float = 10.0,
                               min_conf: float = 0.5, max_conf: float = 0.90,
                               steps: int = 100
                               ) -> Tuple[Optional[np.ndarray], float]:
    """(accepted class-stat rows, best conf) maximizing #classes with mean
    error < px_threshold (get_best_conf_maximize_classes,
    eval_landmarks.py:259-286)."""
    best_n, best_conf, out = 0, 0.0, None
    for conf in np.linspace(min_conf, max_conf, steps):
        sel = err[err[:, -1] > conf]
        if len(sel) == 0:
            continue
        classes = np.unique(sel[:, 0])
        stats = np.array([class_stats(sel, c, conf) for c in classes])
        stats = stats[stats[:, 0].argsort()]
        with np.errstate(invalid="ignore"):
            # column 2 = median error, matching the reference
            # (eval_landmarks.py:281 indexes class_stats[:, 2])
            choose = stats[stats[:, 2] < px_threshold]
        if len(choose) > best_n:
            best_n, best_conf, out = len(choose), float(conf), choose
    return out, best_conf


def best_classes_grid(err: np.ndarray, conf: np.ndarray,
                      px_threshold: float = 10.0, min_conf: float = 0.5,
                      max_conf: float = 0.90, steps: int = 100
                      ) -> Tuple[np.ndarray, float]:
    """Vectorized best_conf_maximize_classes for REGULAR records: err/conf
    are (n_classes, samples) with one row per class.

    Same selection rule (first confidence threshold maximizing #classes
    whose median matched error is under px_threshold,
    eval_landmarks.py:259-286) evaluated as a (steps, n_classes, samples)
    masked nanmedian instead of a per-class Python loop — equivalence with
    best_conf_maximize_classes is tested (tests/test_torch_px_err.py).

    Returns (accepted-class bool mask (n_classes,), best conf).
    """
    err = np.asarray(err, dtype=np.float64)
    conf = np.asarray(conf, dtype=np.float64)
    grid = np.linspace(min_conf, max_conf, steps)
    # matched positives only (err > 0; -1 sentinels are unmatched/missed)
    e = np.where((conf[None] > grid[:, None, None]) & (err[None] > 0),
                 err[None], np.nan)  # (steps, n, S)
    import warnings

    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        # an all-NaN row is a class filtered out at this threshold — the
        # NaN median is the intended sentinel, not an anomaly
        warnings.simplefilter("ignore", RuntimeWarning)
        med = np.nanmedian(e, axis=-1)  # (steps, n); NaN = class filtered out
        ok = med < px_threshold  # NaN compares False
    counts = ok.sum(axis=-1)
    best = int(np.argmax(counts))  # first maximizer, like the `>` loop
    if counts[best] == 0:
        return np.zeros(err.shape[0], dtype=bool), 0.0
    return ok[best], float(grid[best])


def summarize_detector(err: np.ndarray, px_threshold: float = 10.0
                       ) -> Dict[str, float]:
    classes, best_conf = best_conf_maximize_classes(err, px_threshold)
    return {
        "best_conf": best_conf,
        "num_accepted_classes": 0 if classes is None else len(classes),
        "mean_accepted_err": (
            float("nan") if classes is None
            else float(np.nanmean(classes[:, 2]))
        ),
    }
