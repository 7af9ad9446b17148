"""Raster image server: cached region imagery and zero-padded footprint
crops (port of vinsat_tpu/tools/raster.py, host numpy).

`Affine` maps pixels to world coordinates; `RasterImageServer` keeps one
HWC uint8 image a region and cuts the window covering a world box,
zero-padded where the box leaves the image.  Images are registered as
arrays, or loaded from an .npy file or a GeoTIFF (through rasterio where
it is installed, as in the JAX package).  The crops are host work, as in
the JAX package:
through the port's C++ host runtime (native.crop_window) where it is
available, else numpy; the imagery path uploads them to the device as
uint8.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

from vinsat_tpu_torch import native


class Affine(NamedTuple):
    """World = A @ pixel: x_w = a*col + b*row + c; y_w = d*col + e*row + f."""

    a: float
    b: float
    c: float
    d: float
    e: float
    f: float

    def world_to_pixel(self, x, y):
        det = self.a * self.e - self.b * self.d
        col = (self.e * (x - self.c) - self.b * (y - self.f)) / det
        row = (-self.d * (x - self.c) + self.a * (y - self.f)) / det
        return col, row

    def pixel_to_world(self, col, row):
        return (self.a * col + self.b * row + self.c,
                self.d * col + self.e * row + self.f)

    def window_transform(self, col0: int, row0: int) -> "Affine":
        x0, y0 = self.pixel_to_world(col0, row0)
        return Affine(self.a, self.b, x0, self.d, self.e, y0)


class RasterImageServer:
    """Per-region image cache + footprint window crops."""

    def __init__(self):
        self._images: Dict[str, Tuple[np.ndarray, Affine]] = {}

    def register(self, region: str, image: np.ndarray, transform: Affine):
        """Register an HWC uint8 image for a region."""
        self._images[region] = (np.ascontiguousarray(image, np.uint8),
                                transform)

    def load_npy(self, region: str, image_path: str, transform: Affine):
        """Register the HWC uint8 image of an .npy file for a region."""
        self.register(region, np.load(image_path), transform)

    def load_rasterio(self, region: str, tif_path: str) -> bool:
        """Register a GeoTIFF's first three bands with its affine transform
        through rasterio; False (nothing loaded) where rasterio is not
        installed."""
        try:
            import rasterio
        except ImportError:
            return False
        with rasterio.open(tif_path) as src:
            t = src.transform
            data = np.moveaxis(src.read((1, 2, 3)), 0, -1)
        self.register(region, data, Affine(t.a, t.b, t.c, t.d, t.e, t.f))
        return True

    def regions(self):
        return list(self._images)

    def get_window(self, region: str, min_x: float, min_y: float,
                   max_x: float, max_y: float
                   ) -> Tuple[Optional[np.ndarray], Optional[Affine]]:
        """Zero-padded crop of the region image covering the world box, and
        the crop's own transform; (None, None) for an unknown region or an
        empty box."""
        if region not in self._images:
            return None, None
        data, t = self._images[region]
        c0, r0 = t.world_to_pixel(min_x, max_y)  # top-left
        c1, r1 = t.world_to_pixel(max_x, min_y)  # bottom-right
        # floor with an epsilon so that box edges landing on a pixel
        # boundary (up to roundoff in the affine inverse) do not slip one
        # pixel early
        col0, row0 = int(np.floor(c0 + 1e-6)), int(np.floor(r0 + 1e-6))
        ow = int(np.floor(c1 + 1e-6)) - col0
        oh = int(np.floor(r1 + 1e-6)) - row0
        if ow <= 0 or oh <= 0:
            return None, None
        if native.available():
            img = native.crop_window(data, row0, col0, oh, ow)
        else:
            img = crop_numpy(data, row0, col0, oh, ow)
        return img, t.window_transform(col0, row0)


def crop_numpy(data: np.ndarray, row0: int, col0: int, oh: int, ow: int
               ) -> np.ndarray:
    """data[row0:row0 + oh, col0:col0 + ow] of an HWC uint8 image,
    zero-padded where the window leaves the image (native.crop_window's
    numpy twin)."""
    img = np.zeros((oh, ow, data.shape[2]), np.uint8)
    ys, ye = max(0, row0), min(data.shape[0], row0 + oh)
    xs, xe = max(0, col0), min(data.shape[1], col0 + ow)
    if ys < ye and xs < xe:
        img[ys - row0:ye - row0, xs - col0:xe - col0] = data[ys:ye, xs:xe]
    return img
