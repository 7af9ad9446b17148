"""Pluggable detector interface of the detection stage (port of
vinsat_tpu/sim/detector.py).

  * `NoiseModelDetector`: the calibrated statistical stand-in (Gaussian
    pixel noise, uniform confidence), drawing from a CPU
    `torch.Generator` where the JAX package takes a key;
  * `ImageDetector`: the protocol of detectors over raster windows
    (sim/imagery.TemplateDetector, sim/learned_detector.TrainedDetector);
  * `run_image_detector`: one window's detections as global rows.

Both detectors give the reference's row contract [cls, xc, yc, conf] a
window, which becomes [lon, lat, xc, yc, conf] in the full image.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Protocol

import numpy as np
import torch


class NoiseModelDetector(NamedTuple):
    """Gaussian pixel noise + uniform confidence.  noise_px keeps the mean
    |err| under the 10 px acceptance bound (mean |N(0, s)| =
    s sqrt(2 / pi); s = 4 gives ~3.2 px)."""

    noise_px: float = 4.0
    conf_low: float = 0.5
    conf_high: float = 1.0

    def __call__(self, uv_true: torch.Tensor, generator: torch.Generator):
        """(uv, conf) for true pixel positions uv_true (..., 2): the noise,
        then the confidences, drawn from the CPU generator in uv_true's
        dtype and moved to its device."""
        def draw(fn, shape):
            return fn(shape, generator=generator,
                      dtype=uv_true.dtype).to(uv_true.device)

        uv = uv_true + self.noise_px * draw(torch.randn, uv_true.shape)
        conf = self.conf_low + (self.conf_high - self.conf_low) * draw(
            torch.rand, uv_true.shape[:-1])
        return uv, conf


class ImageDetector(Protocol):
    """predict(image, conf_threshold, classes) -> (M, 4) rows
    [cls, xc, yc, conf] in window pixel coordinates: the contract of the
    reference's YOLO stage."""

    def predict(self, image: np.ndarray, conf_threshold: float,
                classes: np.ndarray) -> np.ndarray:
        ...


def run_image_detector(detector: ImageDetector, image: np.ndarray,
                       window_transform, cam_lonlat_to_pixel: Callable,
                       cls_to_lonlat: Callable, conf_threshold: float,
                       classes: np.ndarray) -> np.ndarray:
    """Image-space detections -> global rows [lon, lat, xc, yc, conf]: each
    detection's window pixel goes to lon / lat through the window
    transform and on into full-image pixels through cam_lonlat_to_pixel;
    the class centroid (cls_to_lonlat) is the landmark's identity."""
    dets = detector.predict(image, conf_threshold, classes)
    rows = []
    for cls, xc, yc, conf in np.asarray(dets):
        lon, lat = window_transform.pixel_to_world(xc, yc)
        cls_lon, cls_lat = cls_to_lonlat(int(cls))
        u, v = cam_lonlat_to_pixel(lon, lat)
        rows.append([cls_lon, cls_lat, float(u), float(v), float(conf)])
    return np.array(rows) if rows else np.zeros((0, 5))
