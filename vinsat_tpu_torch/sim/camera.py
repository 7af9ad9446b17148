"""Pinhole nadir camera and WGS84 ray casting (port of
vinsat_tpu/sim/camera.py).

Intrinsics from the horizontal field of view, world -> pixel projection,
pixel -> ray, the closed-form ray ∩ ellipsoid, and the footprint's corner
lon/lats and lon/lat box.  Positions are ECEF metres (the estimator works
in km, ECI).  Everything broadcasts over leading axes; a ray that misses
the Earth gives NaN.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from vinsat_tpu_torch.core import frames

ELLIPSOID_A = 6378137.0  # m
ELLIPSOID_C = 6356752.314245  # m


class CameraModel(NamedTuple):
    """Static intrinsics."""

    width_px: int
    height_px: int
    fx: float
    fy: float
    cx: float
    cy: float

    @classmethod
    def from_hfov(cls, hfov_deg: float = 66.0, width_px: int = 4608,
                  height_px: int = 2592) -> "CameraModel":
        f = (width_px / 2) / math.tan(math.radians(hfov_deg) / 2)
        return cls(width_px, height_px, f, f, width_px / 2, height_px / 2)

    def K(self, dtype=torch.float64, device=None) -> torch.Tensor:
        """The 3x3 intrinsic matrix."""
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=dtype, device=device)


class CameraPose(NamedTuple):
    """Extrinsics: position and world-from-camera rotation, whose columns
    are (right, -up, dir)."""

    position: torch.Tensor  # (..., 3) ECEF m
    R_wc: torch.Tensor  # (..., 3, 3)

    @classmethod
    def from_vectors(cls, position, dir_vec, up_vec, right_vec):
        return cls(position, torch.stack([right_vec, -up_vec, dir_vec],
                                         dim=-1))

    @classmethod
    def nadir(cls, position):
        """Nadir-pointing pose from the position alone."""
        d, u, r = frames.nadir_axes(position)
        return cls.from_vectors(position, d, u, r)


def world_to_pixel(cam: CameraModel, pose: CameraPose, points):
    """ECEF points (..., P, 3) -> pixel coords (..., P, 2) and depth
    (..., P).  Points behind the camera get negative depth; callers mask on
    depth > 0."""
    rel = points - pose.position[..., None, :]
    cam_pts = rel @ pose.R_wc  # R_cw = R_wc^T, applied to each row
    z = cam_pts[..., 2]
    safe_z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = cam.fx * cam_pts[..., 0] / safe_z + cam.cx
    v = cam.fy * cam_pts[..., 1] / safe_z + cam.cy
    return torch.stack([u, v], dim=-1), z


def pixel_to_ray(cam: CameraModel, pose: CameraPose, uv):
    """Pixel coords (..., P, 2) -> unit world rays (..., P, 3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    d_cam = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    d_world = d_cam @ pose.R_wc.transpose(-1, -2)
    return d_world / torch.linalg.vector_norm(d_world, dim=-1, keepdim=True)


def cast_ray_to_earth(origin, direction, a: float = ELLIPSOID_A,
                      c: float = ELLIPSOID_C):
    """First intersection of rays with the WGS84 ellipsoid, closed form:
    origin (..., 3) broadcast against direction (..., P, 3).  Returns the
    points (..., P, 3), NaN where the ray misses (negative radicand or a
    hit behind the origin), and the hit mask (..., P)."""
    b = a
    x, y, z = origin[..., None, 0], origin[..., None, 1], origin[..., None, 2]
    u, v, w = direction[..., 0], direction[..., 1], direction[..., 2]
    a2, b2, c2 = a * a, b * b, c * c
    value = -a2 * b2 * w * z - a2 * c2 * v * y - b2 * c2 * u * x
    radical = (
        a2 * b2 * w**2 + a2 * c2 * v**2 - a2 * v**2 * z**2
        + 2 * a2 * v * w * y * z - a2 * w**2 * y**2 + b2 * c2 * u**2
        - b2 * u**2 * z**2 + 2 * b2 * u * w * x * z - b2 * w**2 * x**2
        - c2 * u**2 * y**2 + 2 * c2 * u * v * x * y - c2 * v**2 * x**2
    )
    magnitude = a2 * b2 * w**2 + a2 * c2 * v**2 + b2 * c2 * u**2
    d = (value - a * b * c * torch.sqrt(radical.clamp(min=0.0))) / magnitude
    hit = (radical >= 0) & (d >= 0)
    pt = origin[..., None, :] + d[..., None] * direction
    return torch.where(hit[..., None], pt, torch.full_like(pt, math.nan)), hit


def corner_rays(cam: CameraModel, pose: CameraPose):
    """Rays through the 4 image corners tl, tr, br, bl, (..., 4, 3)."""
    pos = pose.position
    corners = torch.tensor(
        [[0.0, 0.0], [float(cam.width_px), 0.0],
         [float(cam.width_px), float(cam.height_px)],
         [0.0, float(cam.height_px)]], dtype=pos.dtype, device=pos.device)
    return pixel_to_ray(cam, pose, corners.expand(*pos.shape[:-1], 4, 2))


def footprint_lonlat(cam: CameraModel, pose: CameraPose):
    """Ground-footprint corner (lon, lat) degrees, (..., 4, 2), NaN on a
    miss; and the hit mask (..., 4)."""
    rays = corner_rays(cam, pose)
    pts_m, hit = cast_ray_to_earth(pose.position, rays)
    lat, lon, _ = frames.ecef_to_geodetic(pts_m / 1000.0)
    lonlat = torch.stack([lon, lat], dim=-1)
    return torch.where(hit[..., None], lonlat,
                       torch.full_like(lonlat, math.nan)), hit


def _masked_min(x, hit):
    return torch.where(hit, x, torch.full_like(x, math.inf)).amin(dim=-1)


def _masked_max(x, hit):
    return torch.where(hit, x, torch.full_like(x, -math.inf)).amax(dim=-1)


def footprint_bounds(cam: CameraModel, pose: CameraPose):
    """(lon_min, lat_min, lon_max, lat_max) of the footprint's hit corners,
    (..., 4), and whether all four corners hit, (...,).

    A footprint that straddles ±180° (lon span above 180°) has its negative
    corner longitudes lifted by +360 so the box stays contiguous; lon_max
    may then exceed 180.  The visibility count tests each landmark at lon
    and lon + 360, which is exact for wrapped and plain boxes alike.  With
    no corner hit the box is (inf, inf, -inf, -inf) and holds nothing."""
    lonlat, hit = footprint_lonlat(cam, pose)
    lon, lat = lonlat[..., 0], lonlat[..., 1]
    lon_lo, lon_hi = _masked_min(lon, hit), _masked_max(lon, hit)
    wrap = (lon_hi - lon_lo) > 180.0
    lon_w = torch.where(lon < 0, lon + 360.0, lon)
    lon_min = torch.where(wrap, _masked_min(lon_w, hit), lon_lo)
    lon_max = torch.where(wrap, _masked_max(lon_w, hit), lon_hi)
    bounds = torch.stack([lon_min, _masked_min(lat, hit), lon_max,
                          _masked_max(lat, hit)], dim=-1)
    return bounds, hit.all(dim=-1)


def lonlat_to_pixel(cam: CameraModel, pose: CameraPose, lon_deg, lat_deg):
    """Ground (lon, lat) on the WGS84 surface -> pixel coords and depth."""
    pts_km = frames.geodetic_to_ecef(lat_deg, lon_deg)
    return world_to_pixel(cam, pose, pts_km * 1000.0)
