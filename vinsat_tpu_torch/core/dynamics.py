"""Orbit and attitude dynamics, the simulator's RK4 rollouts, and the RK4
gap bridge with forward sensitivity (port of vinsat_tpu/core/dynamics.py
without the textbook J2 form and the hi-fi force model).

The acceleration keeps the reference's non-standard r_mat J2 form, shared
by simulator and estimator.  Where the JAX package takes each RK4 step's
Jacobian with `jax.vmap(jax.jacfwd(rk4_step))`, the port evaluates the
closed-form RK4 variational step (`rk4_step_with_jacobian`): the same
derivative, with the accelerations' analytic 3x3 Jacobian instead of
forward-mode AD.

Eager PyTorch pays one launch per op, so the gap bridge skips what the
JAX package masks: a hop of length 0 leaves the state (and Jacobian)
unchanged, and the hop schedule is known on the host.  `hop_schedule`
returns the active hops of one gap, and callers that know their gaps on the
host pass the trimmed `num_hops`.

The rollouts (`rollout_orbit`, `rollout_attitude`) are the JAX package's
`lax.scan`s as Python loops of eager steps on the state's device: in f64 on
the card, where the JAX package pins ground truth to the host CPU because
the TPU has no f64.  Each step is a few dozen small launches, so a 10800 s
arc is launch-bound.
"""
from __future__ import annotations

import functools
import math
from typing import List

import torch

from vinsat_tpu_torch.core import quat

MU_EARTH = 398600.4418  # km^3/s^2
J2_COEFF = 1.75553e10  # km^5/s^2, ~ J2*mu*Re^2

# Non-standard J2 weight matrix (same values as vinsat_tpu/core/dynamics.py)
_RMAT = (
    (6.0, -1.5, -1.5),
    (6.0, -1.5, -1.5),
    (3.0, -4.5, -4.5),
)


@functools.lru_cache(maxsize=None)
def _rmat(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """_RMAT on `device`, made once: a host->device copy inside the
    sequential RK4 chains would stall the launch queue every step."""
    return torch.tensor(_RMAT, dtype=dtype, device=device)


def orbit_accel_reference(r, mu=MU_EARTH, j2=J2_COEFF):
    """v_dot = -(mu/|r|^3) r + (j2/|r|^7) (RMAT @ r^2) ∘ r."""
    r2 = r * r
    rn = torch.sqrt(r2.sum(-1, keepdim=True))
    j2_term = r2 @ _rmat(r.device, r.dtype).T
    return -(mu / rn**3) * r + (j2 / rn**7) * j2_term * r


def _orbit_accel_jacobian(r, mu=MU_EARTH, j2=J2_COEFF):
    """d accel / d r, (..., 3, 3), closed form of orbit_accel_reference:

        -mu (rn^-3 I - 3 rn^-5 r r^T)
        + j2 (rn^-7 (diag(t) + 2 RMAT ∘ r r^T) - 7 rn^-9 (t ∘ r) r^T)
    with t = RMAT @ r^2."""
    R = _rmat(r.device, r.dtype)
    r2 = r * r
    rn2 = r2.sum(-1, keepdim=True)
    rn = torch.sqrt(rn2)
    t = r2 @ R.T
    p3 = 1.0 / rn**3
    p7 = j2 / rn**7
    rr = r[..., :, None] * r[..., None, :]
    diag = torch.diag_embed(p7 * t - mu * p3)
    cross = rr * (3.0 * mu * p3 / rn2)[..., None] + (2.0 * p7)[..., None] * R * rr
    tail = (7.0 * p7 / rn2)[..., None] * ((t * r)[..., :, None]
                                          * r[..., None, :])
    return diag + cross - tail


def orbit_dynamics(x):
    """State derivative for x=[r(3), v(3)] in km, km/s."""
    return torch.cat([x[..., 3:6], orbit_accel_reference(x[..., :3])], dim=-1)


def _axpy(x, a, f):
    """x + a * f for a Python-float or tensor step (tensor `a` broadcasts
    against x[..., :1])."""
    if isinstance(a, torch.Tensor):
        return torch.addcmul(x, a, f)
    return torch.add(x, f, alpha=a)


def _as_step(h, x):
    return h.to(x.dtype) if isinstance(h, torch.Tensor) else float(h)


def rk4_step(x, h):
    """One classical RK4 step of the orbit dynamics.  `h` is a Python float
    or a tensor broadcastable to x[..., :1] (per-sample steps)."""
    h = _as_step(h, x)
    f1 = orbit_dynamics(x)
    f2 = orbit_dynamics(_axpy(x, 0.5 * h, f1))
    f3 = orbit_dynamics(_axpy(x, 0.5 * h, f2))
    f4 = orbit_dynamics(_axpy(x, h, f3))
    s = torch.add(torch.add(f1, f2, alpha=2.0), f3, alpha=2.0) + f4
    return _axpy(x, h / 6.0, s)


def rollout_orbit(x0, num_steps: int, h: float):
    """num_steps RK4 steps of the orbit state x0 (..., 6) with step h;
    returns every state, (num_steps + 1, ..., 6)."""
    xs = [x0]
    for _ in range(num_steps):
        xs.append(rk4_step(xs[-1], h))
    return torch.stack(xs)


# 3U CubeSat principal inertia (m = 4 kg, 0.1 x 0.1 x 0.34 m), kg m^2
_M_SAT = 4.0
INERTIA_3U = (
    (_M_SAT / 12) * (0.1**2 + 0.34**2),
    (_M_SAT / 12) * (0.1**2 + 0.34**2),
    (_M_SAT / 12) * (0.1**2 + 0.1**2),
)


@functools.lru_cache(maxsize=None)
def _inertia(inertia_diag, device: torch.device, dtype: torch.dtype):
    return torch.tensor(inertia_diag, dtype=dtype, device=device)


def attitude_dynamics(x, inertia_diag=INERTIA_3U):
    """State derivative for x = [q (4, scalar-last), omega (3)]:
    q_dot = 1/2 q ⊗ [omega, 0]; omega_dot = -J^-1 (omega × J omega)."""
    q = quat.normalize(x[..., :4])
    w = x[..., 4:7]
    wq = torch.cat([w, torch.zeros_like(w[..., :1])], dim=-1)
    q_dot = 0.5 * quat.multiply(q, wq)
    J = _inertia(tuple(inertia_diag), x.device, x.dtype)
    w_dot = -torch.linalg.cross(w, J * w, dim=-1) / J
    return torch.cat([q_dot, w_dot], dim=-1)


def attitude_rk4_step(x, h: float, inertia_diag=INERTIA_3U):
    """One RK4 step of the attitude state, quaternion renormalised."""
    f1 = attitude_dynamics(x, inertia_diag)
    f2 = attitude_dynamics(x + 0.5 * h * f1, inertia_diag)
    f3 = attitude_dynamics(x + 0.5 * h * f2, inertia_diag)
    f4 = attitude_dynamics(x + h * f3, inertia_diag)
    xn = x + (h / 6.0) * (f1 + 2 * f2 + 2 * f3 + f4)
    return torch.cat([quat.normalize(xn[..., :4]), xn[..., 4:7]], dim=-1)


def rollout_attitude(x0, num_steps: int, h: float):
    """num_steps attitude RK4 steps of x0 (..., 7); returns every state,
    (num_steps + 1, ..., 7)."""
    xs = [x0]
    for _ in range(num_steps):
        xs.append(attitude_rk4_step(xs[-1], h))
    return torch.stack(xs)


def _jf_mul(Ja, M):
    """[[0, I], [Ja, 0]] @ M for the 6x6 orbit-dynamics Jacobian."""
    return torch.cat([M[..., 3:6, :], Ja @ M[..., 0:3, :]], dim=-2)


def rk4_step_with_jacobian(x, h):
    """RK4 step and its 6x6 Jacobian d x_next / d x (the closed-form
    variational step: K_j = Jf(x_j) (I + c_j h K_{j-1}))."""
    h = _as_step(h, x)
    eye = torch.eye(6, dtype=x.dtype, device=x.device)
    h6 = h[..., None] if isinstance(h, torch.Tensor) else h

    def f_jac(xx, M):
        Ja = _orbit_accel_jacobian(xx[..., :3])
        return orbit_dynamics(xx), _jf_mul(Ja, M)

    f1, K1 = f_jac(x, eye.expand(*x.shape[:-1], 6, 6))
    f2, K2 = f_jac(_axpy(x, 0.5 * h, f1), _axpy(eye, 0.5 * h6, K1))
    f3, K3 = f_jac(_axpy(x, 0.5 * h, f2), _axpy(eye, 0.5 * h6, K2))
    f4, K4 = f_jac(_axpy(x, h, f3), _axpy(eye, h6, K3))
    s = torch.add(torch.add(f1, f2, alpha=2.0), f3, alpha=2.0) + f4
    S = torch.add(torch.add(K1, K2, alpha=2.0), K3, alpha=2.0) + K4
    return _axpy(x, h / 6.0, s), _axpy(eye, h6 / 6.0, S)


def _hop_sizes(gaps, num_hops: int, max_substep: float):
    """Split per-knot gaps (..., N) into <= num_hops steps of <=
    max_substep: (num_hops, ..., N) step sizes, full hops then one
    remainder hop."""
    k = torch.arange(num_hops, dtype=gaps.dtype, device=gaps.device).reshape(
        -1, *([1] * gaps.dim()))
    full = torch.floor(gaps / max_substep)[None]
    rem = torch.remainder(gaps, max_substep)[None]
    zero = torch.zeros_like(rem)
    return torch.where(k < full, torch.full_like(rem, max_substep),
                       torch.where(k == full, rem, zero))


def hop_schedule(gap: float, num_hops: int, max_substep: float) -> List[float]:
    """The active (non-zero) hops of one gap, on the host: the entries of
    `_hop_sizes` that are > 0, in order."""
    full = math.floor(gap / max_substep)
    rem = gap % max_substep
    hs = [float(max_substep)] * min(full, num_hops)
    if full < num_hops and rem > 0:
        hs.append(float(rem))
    return hs


def active_hops(gaps, max_substep: float) -> int:
    """Number of hops that carry any non-zero step for these host gaps
    (the trimmed `num_hops` that is exact for them)."""
    g = max((float(v) for v in gaps), default=0.0)
    return max(int(math.ceil(g / max_substep)), 1)


def propagate_gaps(pos, vel, gaps, num_hops: int = 16,
                   max_substep: float = 100.0):
    """Propagate each knot state forward by its own gap.  pos, vel
    (..., N, 3); gaps (..., N), broadcast against them.  Returns
    (pos_pred, vel_pred)."""
    x = torch.cat([pos, vel], dim=-1)
    hs = _hop_sizes(gaps.to(x.dtype), num_hops, max_substep)
    for h in hs:
        xn = rk4_step(x, h[..., None])
        x = torch.where((h > 0)[..., None], xn, x)
    return x[..., :3], x[..., 3:6]


def propagate_gaps_with_jacobian(pos, vel, gaps, num_hops: int = 16,
                                 max_substep: float = 100.0):
    """propagate_gaps plus the 6x6 transition Jacobian J_i = d x_pred_i /
    d x_i, chained per hop.  Leading batch dims as in propagate_gaps."""
    x = torch.cat([pos, vel], dim=-1)
    hs = _hop_sizes(gaps.to(x.dtype), num_hops, max_substep)
    J = torch.eye(6, dtype=x.dtype, device=x.device).expand(
        *x.shape[:-1], 6, 6)
    for h in hs:
        xn, A = rk4_step_with_jacobian(x, h[..., None])
        active = (h > 0)[..., None]
        x = torch.where(active, xn, x)
        J = torch.where(active[..., None], A @ J, J)
    return x[..., :3], x[..., 3:6], J


def rk4_chain(x0, hs: List[float]):
    """Sequential RK4 steps of one state (6,) with host-known step sizes;
    returns every state, (len(hs) + 1, 6)."""
    xs = [x0]
    for h in hs:
        xs.append(rk4_step(xs[-1], h))
    return torch.stack(xs)
