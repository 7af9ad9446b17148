"""Orbit and attitude dynamics, the simulator's RK4 rollouts, and the RK4
gap bridge with forward sensitivity (port of vinsat_tpu/core/dynamics.py).

The acceleration keeps the reference's non-standard r_mat J2 form, shared
by simulator and estimator; `textbook_j2=True` takes the standard J2 form
instead (`orbit_accel_textbook`), and `rollout_orbit_hifi` integrates the
hi-fi force model of core/forces.py (the simulator's truth model for the
model-mismatch configuration).  Where the JAX package takes each RK4
step's Jacobian with `jax.vmap(jax.jacfwd(rk4_step))`, the port evaluates
the closed-form RK4 variational step (`rk4_step_with_jacobian`): the same
derivative, with each acceleration's analytic 3x3 Jacobian instead of
forward-mode AD.

Eager PyTorch pays one launch per op, so the gap bridge skips what the
JAX package masks: a hop of length 0 leaves the state (and Jacobian)
unchanged, and the hop schedule is known on the host.  `hop_schedule`
returns the active hops of one gap, and callers that know their gaps on the
host pass the trimmed `num_hops`.

The rollouts (`rollout_orbit`, `rollout_attitude`, `rollout_orbit_hifi`)
are the JAX package's `lax.scan`s as loops of steps on the state's device:
in f64 on the card, where the JAX package pins ground truth to the host
CPU because the TPU has no f64.  A step is dozens (the hi-fi model's,
hundreds) of small kernels: on the CPU the loop runs them eagerly; on a
card the step is captured once as a CUDA graph and replayed a step at a
time (`_rollout`).
"""
from __future__ import annotations

import collections
import functools
import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from vinsat_tpu_torch.config import to_device
from vinsat_tpu_torch.core import forces, quat

MU_EARTH = 398600.4418  # km^3/s^2
J2_COEFF = 1.75553e10  # km^5/s^2, ~ J2*mu*Re^2
J2_UNITLESS = 1.08264e-3
R_EARTH_KM = 6378.137

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


def orbit_accel_textbook(r, mu=MU_EARTH, j2=J2_UNITLESS, re=R_EARTH_KM):
    """Standard J2 acceleration, km/s^2:
    -mu r / rn^3 + c ((5 z^2 / rn^2 - 1) r - 2 z e_z), c = 3 mu J2 Re^2 /
    (2 rn^5)."""
    rn = torch.linalg.vector_norm(r, dim=-1, keepdim=True)
    z = r[..., 2:3]
    a_2bp = -(mu / rn**3) * r
    iz = torch.zeros_like(r)
    iz[..., 2] = 1.0
    coef = 3.0 * mu * j2 * re**2 / (2.0 * rn**5)
    a_j2 = coef * ((5.0 * z**2 / rn**2 - 1.0) * r - 2.0 * z * iz)
    return a_2bp + a_j2


def _textbook_jacobian(r, mu=MU_EARTH, j2=J2_UNITLESS, re=R_EARTH_KM):
    """d accel / d r of orbit_accel_textbook, (..., 3, 3): with s = 5 z^2 /
    rn^2 - 1 and g = s r - 2 z e_z,

        -mu (rn^-3 I - 3 rn^-5 r r^T)
        + c (-5 g r^T / rn^2 + 10 z r e_z^T / rn^2 - 10 z^2 r r^T / rn^4
             + s I - 2 e_z e_z^T)."""
    rn2 = (r * r).sum(-1, keepdim=True)
    rn = torch.sqrt(rn2)
    z = r[..., 2:3]
    iz = torch.zeros_like(r)
    iz[..., 2] = 1.0
    c = 3.0 * mu * j2 * re**2 / (2.0 * rn**5)
    s = 5.0 * z**2 / rn2 - 1.0
    g = s * r - 2.0 * z * iz

    def outer(a, b):
        return a[..., :, None] * b[..., None, :]

    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    two_body = -mu * (eye / rn[..., None] ** 3
                      - 3.0 * outer(r, r) / rn[..., None] ** 5)
    j2_part = (-5.0 * outer(g, r) / rn2[..., None]
               + 10.0 * outer(z * r, iz) / rn2[..., None]
               - 10.0 * (z**2)[..., None] * outer(r, r)
               / (rn2 * rn2)[..., None]
               + s[..., None] * eye - 2.0 * outer(iz, iz))
    return two_body + c[..., None] * j2_part


def _accel(textbook_j2: bool):
    return orbit_accel_textbook if textbook_j2 else orbit_accel_reference


def orbit_dynamics(x, textbook_j2: bool = False):
    """State derivative for x=[r(3), v(3)] in km, km/s."""
    return torch.cat([x[..., 3:6], _accel(textbook_j2)(x[..., :3])], dim=-1)


def _axpy(x, a, f):
    """x + a * f for a Python-float or tensor step (tensor `a` broadcasts
    against x[..., :1])."""
    if isinstance(a, torch.Tensor):
        return torch.addcmul(x, a, f)
    return torch.add(x, f, alpha=a)


def _as_step(h, x):
    return h.to(x.dtype) if isinstance(h, torch.Tensor) else float(h)


def _rk4(f, x, h):
    """One classical RK4 step of x' = f(x, stage), stage 0-3 for the
    evaluations at t, t + h/2, t + h/2, t + h."""
    f1 = f(x, 0)
    f2 = f(_axpy(x, 0.5 * h, f1), 1)
    f3 = f(_axpy(x, 0.5 * h, f2), 2)
    f4 = f(_axpy(x, h, f3), 3)
    s = torch.add(torch.add(f1, f2, alpha=2.0), f3, alpha=2.0) + f4
    return _axpy(x, h / 6.0, s)


def rk4_step(x, h, textbook_j2: bool = False):
    """One classical RK4 step of the orbit dynamics.  `h` is a Python float
    or a tensor broadcastable to x[..., :1] (per-sample steps)."""
    return _rk4(lambda xx, _: orbit_dynamics(xx, textbook_j2), x,
                _as_step(h, x))


def _rollout_loop(step, x0, num_steps: int, rows=None):
    """x0 and num_steps states x <- step(x, rows[k]) (row None without
    `rows`), stacked: (num_steps + 1, *x0.shape)."""
    xs = [x0]
    for k in range(num_steps):
        xs.append(step(xs[-1], None if rows is None else rows[k]))
    return torch.stack(xs)


class _Step(NamedTuple):
    """A captured step of `_rollout` and its static buffers: the state x,
    the rows it reads (None without rows) and its step counter k."""

    graph: torch.cuda.CUDAGraph
    x: torch.Tensor
    rows: Optional[torch.Tensor]
    k: torch.Tensor


# `_rollout`'s kept steps, by the caller's key and the state's device,
# dtype and shape; `kept_captures` counts the captures of kept steps
_kept: Dict[tuple, _Step] = {}
kept_captures = collections.Counter()


def _capture(step, x0, rows) -> _Step:
    """step(x, rows[k]) captured over a static copy of x0, k counting up."""
    dev = x0.device
    x = x0.clone()
    k = torch.zeros(1, dtype=torch.int64, device=dev)

    def body():
        row = None if rows is None else rows.index_select(0, k)[0]
        x.copy_(step(x, row))
        k.add_(1)

    # one eager call on a side stream first (torch's rule before a
    # capture): constants made at first use and library handles exist
    # before the graph records its kernels
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    return _Step(graph, x, rows, k)


def _rollout(step, x0, num_steps: int, rows=None, keep=None):
    """`_rollout_loop`'s result.  On a card the step is captured once as a
    CUDA graph and replayed once a step: the loop's kernels in the loop's
    order, one launch a step in place of one an op.  With `keep` (a key
    naming the step) the captured step and its buffers are kept for later
    calls of the same key, device, dtype and shape, which then enqueue
    their steps without a capture or a host wait; the rows are copied into
    a kept buffer of at least num_steps rows."""
    if x0.device.type != "cuda" or num_steps == 0:
        return _rollout_loop(step, x0, num_steps, rows)
    key = (keep, x0.device, x0.dtype, tuple(x0.shape))
    g = _kept.get(key) if keep is not None else None
    if g is None or (rows is not None and g.rows.shape[0] < num_steps):
        buf = rows
        if keep is not None and rows is not None:
            buf = torch.zeros((1 << (num_steps - 1).bit_length(),)
                              + tuple(rows.shape[1:]), dtype=rows.dtype,
                              device=rows.device)
        g = _capture(step, x0, buf)
        if keep is not None:
            _kept[key] = g
            kept_captures["captures"] += 1
    if rows is not None and g.rows is not rows:
        g.rows[:num_steps].copy_(rows)
    g.x.copy_(x0)
    g.k.zero_()
    out = torch.empty((num_steps + 1,) + tuple(x0.shape), dtype=x0.dtype,
                      device=x0.device)
    out[0] = x0
    for i in range(1, num_steps + 1):
        g.graph.replay()
        out[i].copy_(g.x)
    return out


def rollout_orbit(x0, num_steps: int, h: float, textbook_j2: bool = False):
    """num_steps RK4 steps of the orbit state x0 (..., 6) with step h;
    returns every state, (num_steps + 1, ..., 6)."""
    return _rollout(lambda x, _: rk4_step(x, h, textbook_j2), x0, num_steps)


def rollout_orbit_hifi(x0, num_steps: int, h: float,
                       mjd0_tt: float = 51544.5 + 4700.0):
    """num_steps RK4 steps of x0 (..., 6) under the full hi-fi force model
    (core/forces: J2 + drag + SRP + sun / moon third body); returns every
    state, (num_steps + 1, ..., 6).  The truth model for the estimator's
    model mismatch (the estimation stays two-body + J2).

    The ephemeris epoch advances with the integration time: a stage at
    time t (seconds from the start, accumulated step by step as the JAX
    package's carry) reads the sun and moon at mjd0_tt + t / 86400.  The
    ephemerides (and the sun's direction for the density) depend on time
    alone, so those of all stage times are evaluated in one batch before
    the steps."""
    t, stage_t = 0.0, []
    for _ in range(num_steps):
        stage_t.append((t, t + 0.5 * h, t + 0.5 * h, t + h))
        t = t + h
    mjd = mjd0_tt + torch.tensor(stage_t, dtype=torch.float64,
                                 device=x0.device).reshape(-1, 4) / 86400.0
    r_sun = forces.sun_position(mjd)
    # a step's row: each stage's sun, moon and sun direction, (4, 9)
    eph = torch.cat([r_sun, forces.moon_position(mjd),
                     forces.sun_direction(r_sun)], dim=-1)

    def step(x, row):
        def f(xx, stage):
            a = forces.hifi_accel_from_ephemeris(
                xx[..., :3], xx[..., 3:6], row[stage, 0:3], row[stage, 3:6],
                row[stage, 6:9])
            return torch.cat([xx[..., 3:6], a], dim=-1)

        return _rk4(f, x, h)

    return _rollout(step, x0, num_steps, eph)


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
    return _rollout(lambda x, _: attitude_rk4_step(x, h), x0, num_steps)


def _jf_mul(Ja, M):
    """[[0, I], [Ja, 0]] @ M for the 6x6 orbit-dynamics Jacobian."""
    return torch.cat([M[..., 3:6, :], Ja @ M[..., 0:3, :]], dim=-2)


def rk4_step_with_jacobian(x, h, textbook_j2: bool = False):
    """RK4 step and its 6x6 Jacobian d x_next / d x (the closed-form
    variational step: K_j = Jf(x_j) (I + c_j h K_{j-1}))."""
    h = _as_step(h, x)
    eye = torch.eye(6, dtype=x.dtype, device=x.device)
    h6 = h[..., None] if isinstance(h, torch.Tensor) else h
    accel_jac = _textbook_jacobian if textbook_j2 else _orbit_accel_jacobian

    def f_jac(xx, M):
        Ja = accel_jac(xx[..., :3])
        return orbit_dynamics(xx, textbook_j2), _jf_mul(Ja, M)

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
                   max_substep: float = 100.0, textbook_j2: bool = False):
    """Propagate each knot state forward by its own gap.  pos, vel
    (..., N, 3); gaps (..., N), broadcast against them.  Returns
    (pos_pred, vel_pred)."""
    x = torch.cat([pos, vel], dim=-1)
    hs = _hop_sizes(gaps.to(x.dtype), num_hops, max_substep)
    for h in hs:
        xn = rk4_step(x, h[..., None], textbook_j2)
        x = torch.where((h > 0)[..., None], xn, x)
    return x[..., :3], x[..., 3:6]


def propagate_gaps_with_jacobian(pos, vel, gaps, num_hops: int = 16,
                                 max_substep: float = 100.0,
                                 textbook_j2: bool = False):
    """propagate_gaps plus the 6x6 transition Jacobian J_i = d x_pred_i /
    d x_i, chained per hop.  Leading batch dims as in propagate_gaps."""
    x = torch.cat([pos, vel], dim=-1)
    hs = _hop_sizes(gaps.to(x.dtype), num_hops, max_substep)
    J = torch.eye(6, dtype=x.dtype, device=x.device).expand(
        *x.shape[:-1], 6, 6)
    for h in hs:
        xn, A = rk4_step_with_jacobian(x, h[..., None], textbook_j2)
        active = (h > 0)[..., None]
        x = torch.where(active, xn, x)
        J = torch.where(active[..., None], A @ J, J)
    return x[..., :3], x[..., 3:6], J


def rk4_chain(x0, hs: List[float]):
    """Sequential RK4 steps of one state (6,) with host-known step sizes;
    returns every state, (len(hs) + 1, 6).  On a card the step is
    `_rollout`'s captured graph, kept for later chains (one a device,
    dtype and step): one equal step keeps its Python float (the eager
    loop's kernels), mixed steps read theirs as a row uploaded from pinned
    memory, so a chain enqueues its steps without a host wait."""
    if x0.device.type != "cuda" or not hs:
        xs = [x0]
        for h in hs:
            xs.append(rk4_step(xs[-1], h))
        return torch.stack(xs)
    if all(h == hs[0] for h in hs):
        h0 = float(hs[0])
        return _rollout(lambda x, _: rk4_step(x, h0), x0, len(hs),
                        keep=("rk4", h0))
    rows = to_device(np.asarray(hs), x0.dtype, x0.device)
    return _rollout(rk4_step, x0, len(hs), rows, keep=("rk4", None))


def propagate_dense(pos0, vel0, duration: int, h: float = 1.0,
                    textbook_j2: bool = False):
    """Dense propagation of one state (pos0, vel0) for `duration` steps of
    h; returns (duration + 1, 6)."""
    return rollout_orbit(torch.cat([pos0, vel0], dim=-1), duration, h,
                         textbook_j2)
