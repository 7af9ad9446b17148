"""Orbital elements, random orbit sampling and trajectory generation (port
of vinsat_tpu/sim/orbits.py).

Keplerian <-> Cartesian conversion, the polar / ISS-like samplers and the
position + attitude rollout of one arc.  The samplers draw from an explicit
CPU `torch.Generator`, whose stream is not JAX's threefry: a port seed gives
another orbit than the same JAX seed.  `trajectory_from_draws` is the
deterministic core that takes the draws (elements, initial attitude and
rates), so the port can be held to the JAX package on JAX's own draws.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from vinsat_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from vinsat_tpu_torch.core import dynamics, frames

R_EARTH_KM = 6378.0  # the reference's spherical radius for altitude offsets


class OrbitalElements(NamedTuple):
    """Classical orbital elements (a in km, angles in rad): floats or
    tensors of one shape."""

    a: torch.Tensor
    e: torch.Tensor
    i: torch.Tensor
    Omega: torch.Tensor
    omega: torch.Tensor
    nu: torch.Tensor


def _rotz(g):
    c, s = torch.cos(g), torch.sin(g)
    z, o = torch.zeros_like(g), torch.ones_like(g)
    return torch.stack([torch.stack([c, -s, z], dim=-1),
                        torch.stack([s, c, z], dim=-1),
                        torch.stack([z, z, o], dim=-1)], dim=-2)


def _rotx(a):
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([torch.stack([o, z, z], dim=-1),
                        torch.stack([z, c, -s], dim=-1),
                        torch.stack([z, s, c], dim=-1)], dim=-2)


def anomaly_true_to_eccentric(nu, e):
    """True anomaly -> eccentric anomaly."""
    E = torch.arccos((e + torch.cos(nu)) / (1 + e * torch.cos(nu)))
    return torch.where(nu > math.pi, 2 * math.pi - E, E)


def oe_to_eci(oe: OrbitalElements, mu: float = dynamics.MU_EARTH):
    """Keplerian elements (tensors) -> ECI state [r (3), v (3)] km, km/s."""
    n = torch.sqrt(mu / oe.a**3)
    E = anomaly_true_to_eccentric(oe.nu, oe.e)
    se, ce = torch.sin(E), torch.cos(E)
    b = torch.sqrt(1 - oe.e**2)
    zero = torch.zeros_like(E)
    r_peri = torch.stack([oe.a * (ce - oe.e), oe.a * b * se, zero], dim=-1)
    v_peri = (oe.a * n / (1 - oe.e * ce))[..., None] * torch.stack(
        [-se, b * ce, zero], dim=-1)
    R = _rotz(oe.Omega) @ _rotx(oe.i) @ _rotz(oe.omega)
    r = (R @ r_peri[..., None])[..., 0]
    v = (R @ v_peri[..., None])[..., 0]
    return torch.cat([r, v], dim=-1)


def eci_to_oe(x, mu: float = dynamics.MU_EARTH) -> OrbitalElements:
    """ECI state (..., 6) -> orbital elements, batched."""
    R, V = x[..., :3], x[..., 3:6]
    r = torch.linalg.vector_norm(R, dim=-1)
    v = torch.linalg.vector_norm(V, dim=-1)
    H = torch.linalg.cross(R, V, dim=-1)
    h = torch.linalg.vector_norm(H, dim=-1)
    zhat = torch.zeros_like(R)
    zhat[..., 2] = 1.0
    Nv = torch.linalg.cross(zhat, H, dim=-1)
    n = torch.linalg.vector_norm(Nv, dim=-1)
    rv = (R * V).sum(-1)
    e_vec = ((v**2 - mu / r)[..., None] * R - rv[..., None] * V) / mu
    e = torch.linalg.vector_norm(e_vec, dim=-1)
    a = -mu / (2 * (0.5 * v**2 - mu / r))
    i = torch.arccos(torch.clamp(H[..., 2] / h, -1, 1))
    Omega = torch.arccos(torch.clamp(Nv[..., 0] / n, -1, 1))
    Omega = torch.where(Nv[..., 1] < 0, 2 * math.pi - Omega, Omega)
    om = torch.arccos(torch.clamp((Nv * e_vec).sum(-1) / (n * e), -1, 1))
    om = torch.where(e_vec[..., 2] < 0, 2 * math.pi - om, om)
    nu = torch.arccos(torch.clamp((e_vec * R).sum(-1) / (e * r), -1, 1))
    nu = torch.where(rv < 0, 2 * math.pi - nu, nu)
    return OrbitalElements(a, e, i, Omega, om, nu)


# ---------------------------------------------------------------------------
# Random orbit sampling: each draw is one float from `generator`
# ---------------------------------------------------------------------------


def _uniform(generator: torch.Generator) -> float:
    return float(torch.rand((), generator=generator, dtype=torch.float64))


def _sample_oe(generator, i0: float, i_jitter: float, a_min_alt: float,
               a_max_alt: float) -> OrbitalElements:
    a = R_EARTH_KM + a_min_alt + (a_max_alt - a_min_alt) * _uniform(generator)
    e = 0.01 * _uniform(generator)
    i = i0 + i_jitter * (_uniform(generator) - 0.5)
    ang = 2 * math.pi * _uniform(generator)
    return OrbitalElements(a, e, i, ang, ang, ang)


def sample_polar_oe(generator: torch.Generator, a_min_alt=525.0,
                    a_max_alt=575.0) -> OrbitalElements:
    """Near-polar orbit: i ~ 90 deg +- 0.1 rad, 525-575 km altitude."""
    return _sample_oe(generator, math.pi / 2, 0.2, a_min_alt, a_max_alt)


def sample_iss_like_oe(generator: torch.Generator, a_min_alt=525.0,
                       a_max_alt=575.0) -> OrbitalElements:
    """ISS-like orbit: i ~ 51.5 deg +- 0.05 rad, 525-575 km altitude."""
    return _sample_oe(generator, 51.5 * math.pi / 180, 0.1, a_min_alt,
                      a_max_alt)


def sample_random_oe(generator: torch.Generator) -> OrbitalElements:
    """ISS-like or polar with probability 1/2 each."""
    if _uniform(generator) < 0.5:
        return sample_iss_like_oe(generator)
    return sample_polar_oe(generator)


def sample_attitude(generator: torch.Generator):
    """Tumbling initial attitude: a uniformly random unit quaternion (4,)
    and body rates of ~2 deg/s per axis (3,), float64 on the CPU."""
    q0 = torch.randn(4, generator=generator, dtype=torch.float64)
    w0 = 2 * (math.pi / 180) * torch.randn(3, generator=generator,
                                           dtype=torch.float64)
    return q0 / torch.linalg.vector_norm(q0), w0


# ---------------------------------------------------------------------------
# Trajectory generation
# ---------------------------------------------------------------------------


class Trajectory(NamedTuple):
    """A simulated orbit arc at 1/dt Hz.

    pos_eci (T, 3) km, vel_eci (T, 3) km/s, quat_nadir_eci (T, 4) the
    nadir-pointing attitude (ECI, scalar-last), quat_body_eci (T, 4) the
    tumbling rigid-body attitude, omega_body (T, 3) rad/s its body rates,
    times (T,) s.
    """

    pos_eci: torch.Tensor
    vel_eci: torch.Tensor
    quat_nadir_eci: torch.Tensor
    quat_body_eci: torch.Tensor
    omega_body: torch.Tensor
    times: torch.Tensor

    @property
    def pos_ecef(self):
        return frames.eci_to_ecef(self.pos_eci, self.times)


def trajectory_from_draws(oe: OrbitalElements, q0, w0, duration_s: int =
                          10800, dt: float = 1.0,
                          device=DEFAULT_DEVICE) -> Trajectory:
    """Position + attitude rollout of one arc from its draws: elements
    `oe`, unit quaternion q0 (4,) and body rates w0 (3,) rad/s.  Both
    rollouts run in f64 on `device`."""
    device = resolve_device(device)

    def t(v):
        if isinstance(v, torch.Tensor):
            return v.to(device=device, dtype=torch.float64)
        return torch.tensor(np.asarray(v, np.float64), device=device)

    x0 = oe_to_eci(OrbitalElements(*(t(v) for v in oe)))
    num_steps = int(round(duration_s / dt))
    orbit = dynamics.rollout_orbit(x0, num_steps, dt)
    att = dynamics.rollout_attitude(torch.cat([t(q0), t(w0)]), num_steps, dt)
    pos = orbit[:, :3]
    return Trajectory(
        pos_eci=pos, vel_eci=orbit[:, 3:6],
        quat_nadir_eci=frames.nadir_quaternion(pos),
        quat_body_eci=att[:, :4], omega_body=att[:, 4:7],
        times=torch.arange(num_steps + 1, dtype=torch.float64,
                           device=device) * dt)


def generate_trajectory(generator: torch.Generator,
                        oe: Optional[OrbitalElements] = None,
                        duration_s: int = 10800, dt: float = 1.0,
                        device=DEFAULT_DEVICE) -> Trajectory:
    """Simulate one position + attitude arc: elements from
    `sample_random_oe` unless given, then the initial attitude, drawn from
    the CPU `generator`."""
    if oe is None:
        oe = sample_random_oe(generator)
    q0, w0 = sample_attitude(generator)
    return trajectory_from_draws(oe, q0, w0, duration_s, dt, device)
