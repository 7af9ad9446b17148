"""Constants the streaming slice reads (port of vinsat_tpu/config.py).

Only the reference camera's intrinsics are needed: the JAX module's
dataclasses carry solver/window defaults that the port keeps in
SolverParams / StreamingConfig, exactly as the JAX hot path does.
"""
from __future__ import annotations

import math

# CameraConfig defaults (config.py:24-26): 66 deg HFOV at 4608x2592
_WIDTH_PX = 4608
_HEIGHT_PX = 2592
_HFOV_DEG = 66.0
_FOCAL_PX = (_WIDTH_PX / 2) / math.tan(math.radians(_HFOV_DEG) / 2)

# (fx, fy, cx, cy) — equals vinsat_tpu.config.REFERENCE_INTRINSICS
REFERENCE_INTRINSICS = (_FOCAL_PX, _FOCAL_PX, _WIDTH_PX / 2.0,
                        _HEIGHT_PX / 2.0)
