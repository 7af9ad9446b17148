"""Orbit-error evaluation: time-to-<threshold metrics (numpy copy of
vinsat_tpu/evalx/ate.py's time_to_threshold / cumulative_fraction /
summarize; the JAX module cannot be imported without JAX)."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def time_to_threshold(errors: np.ndarray, times: np.ndarray,
                      threshold_km: float = 5.0) -> Optional[float]:
    """First time the error drops below threshold; None if never."""
    below = np.asarray(errors) < threshold_km
    if not below.any():
        return None
    return float(np.asarray(times)[int(np.argmax(below))])


def cumulative_fraction(errors_list: Sequence[np.ndarray],
                        times_list: Sequence[np.ndarray],
                        threshold_km: float = 5.0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted first-crossing times + cumulative fraction of ALL orbits."""
    t5: List[float] = []
    for e, t in zip(errors_list, times_list):
        tt = time_to_threshold(e, t, threshold_km)
        if tt is not None:
            t5.append(tt)
    t5_sorted = np.sort(np.array(t5))
    frac = np.arange(1, len(t5_sorted) + 1) / max(len(errors_list), 1)
    return t5_sorted, frac


def summarize(errors_list: Sequence[np.ndarray],
              times_list: Sequence[np.ndarray]) -> Dict[str, float]:
    """Convergence fraction and median time-to-5/2/1 km across orbits, and
    the median final error."""
    out = {}
    for thr in (5.0, 2.0, 1.0):
        ts, frac = cumulative_fraction(errors_list, times_list, thr)
        key = f"{thr:g}km"
        out[f"frac_reaching_{key}"] = float(frac[-1]) if len(frac) else 0.0
        out[f"median_time_to_{key}"] = (
            float(np.median(ts)) if len(ts) else float("nan"))
    final_errs = [float(np.asarray(e)[-1]) for e in errors_list if len(e)]
    out["median_final_error_km"] = (
        float(np.median(final_errs)) if final_errs else float("nan"))
    return out
