"""Checkpoint / resume of a streaming run (port of
vinsat_tpu/utils/checkpoint.py's npz format).

The stream's algorithmic checkpoint is what each window hands the next:
its optimized states and trailing Hessian, λ, the window cursor and the
errors recorded so far, plus the bounded mode's anchor information and
the NEES history (`extra`).  The keys and dtypes are the JAX package's, so
a checkpoint written by either package resumes in the other.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np


def save(path: str, *, states: np.ndarray, last_hessian: Optional[np.ndarray],
         window_idx: int, lamda: float, knot_times: np.ndarray,
         errors: np.ndarray, times: np.ndarray, extra: Optional[Dict] = None):
    """Write one window's checkpoint to `path` (an .npz)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(
        path,
        states=states,
        last_hessian=(np.zeros((9, 9)) if last_hessian is None
                      else last_hessian),
        has_hessian=np.array(last_hessian is not None),
        window_idx=np.array(window_idx),
        lamda=np.array(lamda),
        knot_times=knot_times,
        errors=errors,
        times=times,
        **(extra or {}),
    )


def load(path: str) -> Dict[str, Any]:
    """Read a checkpoint (".npz" appended when missing): its arrays, with
    window_idx an int, lamda a float and last_hessian None when the writer
    had none."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        out = {k: z[k] for k in z.files}
    out["window_idx"] = int(out["window_idx"])
    out["lamda"] = float(out["lamda"])
    if not bool(out.pop("has_hessian")):
        out["last_hessian"] = None
    return out
