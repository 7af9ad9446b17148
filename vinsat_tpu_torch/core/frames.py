"""Reference frames: GMST Earth rotation, ECI<->ECEF, geodetic->ECEF, nadir
attitude (port of the parts of vinsat_tpu/core/frames.py that GT
conditioning needs).  Kilometres throughout.
"""
from __future__ import annotations

import math

import torch

from vinsat_tpu_torch.core import quat

THETA_G0_DEG = 280.16
OMEGA_EARTH_DEG_PER_S = 360.0 / 86164.100352

WGS84_A_KM = 6378.137
WGS84_B_KM = 6356.752
WGS84_E2 = 1.0 - (WGS84_B_KM**2 / WGS84_A_KM**2)


def _deg2rad(x):
    return x * (math.pi / 180.0)


def gmst_rad(times_s):
    """Greenwich mean sidereal angle at t seconds past the epoch (radians)."""
    return _deg2rad(THETA_G0_DEG + OMEGA_EARTH_DEG_PER_S * times_s)


def rz_eci_to_ecef(times_s):
    """Rotation matrix R(t) with r_ecef = R @ r_eci; (..., 3, 3)."""
    th = gmst_rad(times_s)
    c, s = torch.cos(th), torch.sin(th)
    zero = torch.zeros_like(th)
    one = torch.ones_like(th)
    return torch.stack(
        [
            torch.stack([c, s, zero], dim=-1),
            torch.stack([-s, c, zero], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )


def eci_to_ecef(r_eci, times_s):
    """ECI -> ECEF positions."""
    return torch.einsum("...ij,...j->...i", rz_eci_to_ecef(times_s), r_eci)


def ecef_to_eci(r_ecef, times_s):
    """ECEF -> ECI positions."""
    th = gmst_rad(times_s)
    c, s = torch.cos(th), torch.sin(th)
    x, y, z = r_ecef[..., 0], r_ecef[..., 1], r_ecef[..., 2]
    return torch.stack([x * c - y * s, x * s + y * c, z], dim=-1)


def geodetic_to_ecef(lat_deg, lon_deg, alt_km=0.0):
    """Geodetic lat/lon/alt -> ECEF km."""
    phi = _deg2rad(lat_deg)
    lam = _deg2rad(lon_deg)
    N = WGS84_A_KM / torch.sqrt(1.0 - WGS84_E2 * torch.sin(phi) ** 2)
    x = (N + alt_km) * torch.cos(phi) * torch.cos(lam)
    y = (N + alt_km) * torch.cos(phi) * torch.sin(lam)
    z = ((WGS84_B_KM**2 / WGS84_A_KM**2) * N + alt_km) * torch.sin(phi)
    return torch.stack([x, y, z], dim=-1)


def lonlat_to_eci(lon_deg, lat_deg, times_s, alt_km=0.0):
    """Ground point (lon, lat) at frame time t -> ECI km."""
    return ecef_to_eci(geodetic_to_ecef(lat_deg, lon_deg, alt_km), times_s)


def nadir_rotation(pos):
    """Nadir-pointing camera rotation R = [xc | yc | zc] (columns) with the
    boresight zc at Earth's centre."""
    zc = -pos / torch.linalg.vector_norm(pos, dim=-1, keepdim=True)
    zhat = torch.zeros_like(pos)
    zhat[..., 2] = 1.0
    rc = torch.linalg.cross(zhat, zc, dim=-1)
    rc = rc / torch.linalg.vector_norm(rc, dim=-1, keepdim=True)
    xc = -rc
    yc = torch.linalg.cross(rc, zc, dim=-1)
    return torch.stack([xc, yc, zc], dim=-1)  # columns


def nadir_quaternion(pos):
    """Scalar-last quaternion of the nadir rotation."""
    return quat.from_matrix(nadir_rotation(pos))
