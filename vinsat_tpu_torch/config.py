"""Constants the port reads (port of vinsat_tpu/config.py), and the
default device of its entry points.

Only the reference camera's intrinsics are needed: the JAX module's
dataclasses carry solver/window defaults that the port keeps in
SolverParams / StreamingConfig, exactly as the JAX hot path does.
"""
from __future__ import annotations

import math

import torch

# CameraConfig defaults (config.py:24-26): 66 deg HFOV at 4608x2592
_WIDTH_PX = 4608
_HEIGHT_PX = 2592
_HFOV_DEG = 66.0
_FOCAL_PX = (_WIDTH_PX / 2) / math.tan(math.radians(_HFOV_DEG) / 2)

# (fx, fy, cx, cy) — equals vinsat_tpu.config.REFERENCE_INTRINSICS
REFERENCE_INTRINSICS = (_FOCAL_PX, _FOCAL_PX, _WIDTH_PX / 2.0,
                        _HEIGHT_PX / 2.0)

# Every entry point of the port runs on the card unless the caller names
# another device; without one it raises instead of carrying on on the CPU.
DEFAULT_DEVICE = torch.device("cuda")


def resolve_device(device) -> torch.device:
    """`device` (a torch.device or its name; None means the default) as a
    torch.device.  A CUDA device that this process cannot reach raises."""
    device = DEFAULT_DEVICE if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    return device
