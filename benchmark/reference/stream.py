"""The plain reference of streaming orbit determination, frozen here so
that a change to the program cannot move the yardstick.

Plain PyTorch, eager, on any device, one orbit at a time: the rows are
ingested into the detection graph and gated on the ground truth's
reprojection, the initial states are GT plus noise drawn from
numpy's default_rng(seed), the graph is split into windows at detection
gaps, each window (a growing prefix of the knots, padded to buckets)
is solved by robust Levenberg-Marquardt (reprojection and dynamics
factors, the block-tridiagonal normal equations, a batched damping
search of 9 candidates, Jacobi-scaled block solves: the Thomas scan below
64 padded knots, parallel cyclic reduction from 64, retraction), the
best-residual iterate is kept, a window whose reprojection RMS exceeds
12 px is solved again with heavy damping, the solved prefix is
propagated by RK4 across each gap, the last window's knots are refined by
two shooting fits, and the last knot is propagated to the arc's end.  The
recorded errors and times and the final knot states are what the cell
compares.

The arithmetic is that of vinsat_tpu_torch/estimation/{window,ba,
factors,ingest,refine}.py, core/{dynamics,quat,frames}.py and the plain
twin of kernel K1 (kernels/tridiag_pcr.py) as they stood when the
benchmark was written, in the same algorithms.  The sequential RK4
chains run in numpy on the host (benchmark/inputs/sim.py).  It imports
nothing of the program.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from benchmark.inputs import sim

WIDTH_PX, HEIGHT_PX = sim.WIDTH_PX, sim.HEIGHT_PX
INTRINSICS = (sim.FOCAL_PX, sim.FOCAL_PX, sim.CX, sim.CY)
KNOT_STRIDE = 1000
PCR_MIN_N = 64


class Config(NamedTuple):
    """The stream's settings (the program's StreamingConfig defaults and
    SolverParams defaults that the stream reads)."""

    num_iters: int = 20
    init_iters: int = 10
    max_iters: int = 60
    max_iters_later: int = 24
    budget_span_min_s: float = 1200.0
    lambda_init: float = 1e-4
    noise_pos_km: float = 100.0
    noise_ori_rad: float = 0.2
    noise_vel_rel: float = 0.1
    knot_bucket: int = 16
    obs_bucket: int = 64
    batched_lambda: int = 9
    tail_att_sigma: float = 1e-2
    tail_ratio: float = 1.3
    recover_rms_px: float = 12.0
    quat_coeff: float = 100.0
    vel_coeff: float = 100.0
    sigma_scale: float = 1e4
    sigma_max: float = 1e6
    lambda_max: float = 1e4
    lambda_growth: float = 10.0
    num_hops: int = 16
    max_substep: float = 100.0


class Result(NamedTuple):
    errors: np.ndarray  # (K,) km at the recorded times
    times: np.ndarray  # (K,) frame of each
    final_states: np.ndarray  # (N, 10)
    knot_times: np.ndarray  # (N,)
    recovery_trips: int


# ---------------------------------------------------------------------------
# quaternions (scalar last) and frames
# ---------------------------------------------------------------------------


def q_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def q_mul(q1, q2):
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], dim=-1)


def q_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def q_exp(phi):
    t2 = (phi * phi).sum(-1, keepdim=True)
    small = t2 < 1e-12
    theta = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    sinc_half = torch.where(small, 0.5 - t2 / 48.0,
                            torch.sin(theta / 2.0) / theta)
    w = torch.where(small, 1.0 - t2 / 8.0, torch.cos(theta / 2.0))
    return torch.cat([phi * sinc_half, w], dim=-1)


def q_log(q):
    q = torch.clamp(q_normalize(q), -1.0, 1.0)
    theta = 2.0 * torch.arccos(torch.clamp(q[..., 3], -1.0, 1.0))
    s = torch.sin(theta / 2)
    tiny = s.abs() < 1e-12
    out = (q[..., :3] / torch.where(tiny, torch.ones_like(s), s)[..., None]
           * theta[..., None])
    return torch.where(tiny[..., None], 2.0 * q[..., :3], out)


def q_rotate_inverse(q, v):
    qn = q_normalize(q)
    vq = torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)
    return q_mul(q_conj(qn), q_mul(vq, qn))[..., :3]


def q_to_matrix(q):
    x, y, z, w = q_normalize(q).unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def q_from_matrix(R):
    """Shepperd's method, the best of four candidates."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    cands = torch.stack([
        torch.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20],
                    -1),
        torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21],
                    -1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22],
                    -1)], -2)
    best = torch.argmax(torch.stack([tr, m00, m11, m22], -1), dim=-1)
    wxyz = torch.gather(cands, -2, best[..., None, None].expand(
        *best.shape, 1, 4))[..., 0, :]
    return q_normalize(torch.cat([wxyz[..., 1:], wxyz[..., :1]], dim=-1))


def attitude_jacobian(q):
    x, y, z, w = q.unbind(-1)
    return torch.stack([torch.stack([w, -z, y], -1),
                        torch.stack([z, w, -x], -1),
                        torch.stack([-y, x, w], -1),
                        torch.stack([-x, -y, -z], -1)], -2)


def nadir_quaternion(pos):
    zc = -pos / torch.linalg.vector_norm(pos, dim=-1, keepdim=True)
    zhat = torch.zeros_like(pos)
    zhat[..., 2] = 1.0
    rc = torch.linalg.cross(zhat, zc, dim=-1)
    rc = rc / torch.linalg.vector_norm(rc, dim=-1, keepdim=True)
    yc = torch.linalg.cross(rc, zc, dim=-1)
    return q_from_matrix(torch.stack([-rc, yc, zc], dim=-1))


def lonlat_to_eci(lon_deg, lat_deg, times):
    phi, lam = lat_deg * (math.pi / 180.0), lon_deg * (math.pi / 180.0)
    N = sim.WGS84_A_KM / torch.sqrt(1.0 - sim.WGS84_E2 * torch.sin(phi) ** 2)
    x = N * torch.cos(phi) * torch.cos(lam)
    y = N * torch.cos(phi) * torch.sin(lam)
    z = (sim.WGS84_B_KM**2 / sim.WGS84_A_KM**2) * N * torch.sin(phi)
    th = (sim.THETA_G0_DEG + sim.OMEGA_EARTH_DEG_PER_S * times) * (
        math.pi / 180.0)
    c, s = torch.cos(th), torch.sin(th)
    return torch.stack([x * c - y * s, x * s + y * c, z], dim=-1)


def inclusive_scan(x, combine):
    """Log-depth inclusive scan along dim 0 (combine(earlier, later))."""
    n, d = x.shape[0], 1
    while d < n:
        x = torch.cat([x[:d], combine(x[:-d], x[d:])], dim=0)
        d *= 2
    return x


# ---------------------------------------------------------------------------
# ingest: the detection graph, the gate, the windows
# ---------------------------------------------------------------------------


class Graph(NamedTuple):
    frame: np.ndarray
    uv: np.ndarray
    lonlat: np.ndarray
    conf: np.ndarray
    time_idx: np.ndarray
    ii: np.ndarray


def build_graph(rows: np.ndarray, orbit_len: int) -> Graph:
    """Knots at each detection frame plus filler knots every KNOT_STRIDE
    frames between and after the detections."""
    rows = rows[np.argsort(rows[:, 0], kind="stable")]
    frame = rows[:, 0]
    det_times = np.unique(frame).astype(np.int64)
    ii: List[int] = []
    knots: List[int] = []
    filler = det_times.min() // KNOT_STRIDE + 1
    offset = 0
    for i, t in enumerate(det_times):
        while filler * KNOT_STRIDE < t:
            knots.append(filler * KNOT_STRIDE)
            filler += 1
            offset += 1
        if filler * KNOT_STRIDE == t:
            filler += 1
        knots.append(int(t))
        ii.extend([i + offset] * int((frame == t).sum()))
    if det_times[-1] < orbit_len:
        while filler * KNOT_STRIDE < (orbit_len // KNOT_STRIDE) \
                * KNOT_STRIDE + 1:
            knots.append(filler * KNOT_STRIDE)
            filler += 1
    return Graph(frame, rows[:, 3:5], rows[:, 1:3], rows[:, 5],
                 np.array(knots, np.int64), np.array(ii, np.int64))


def split_windows(ii, time_idx, contiguous_gap=100, split_gap=200,
                  min_contiguous=4):
    """(t_final, i_final, seq_end) of each window: a split at a detection
    gap > split_gap after > min_contiguous contiguous detections."""
    out, i = [], 0
    while True:
        contiguous, found = 0, False
        for j in range(i + 1, len(ii)):
            gap = time_idx[ii[j]] - time_idx[ii[j - 1]]
            if gap < contiguous_gap:
                contiguous += 1
            if gap > split_gap and contiguous > min_contiguous:
                out.append((int(ii[j - 1] + 1), int(j), False))
                i, found = j, True
                break
        if not found:
            out.append((int(ii[-1] + 1), int(len(ii)), True))
            return out


def bucket(n: int, step: int = 16, minimum: int = 16) -> int:
    m = max(minimum, step, n)
    p = 1 << (m - 1).bit_length()
    q = max(minimum, step, p // 8)
    return ((m + q - 1) // q) * q


# ---------------------------------------------------------------------------
# dynamics: J2 RK4 with its variational step
# ---------------------------------------------------------------------------


def _rmat(x):
    return torch.tensor(sim.RMAT, dtype=x.dtype, device=x.device)


def accel(r):
    r2 = r * r
    rn = torch.sqrt(r2.sum(-1, keepdim=True))
    return (-(sim.MU_EARTH / rn**3) * r
            + (sim.J2_COEFF / rn**7) * (r2 @ _rmat(r).T) * r)


def accel_jacobian(r):
    R = _rmat(r)
    r2 = r * r
    rn2 = r2.sum(-1, keepdim=True)
    rn = torch.sqrt(rn2)
    t = r2 @ R.T
    p3 = 1.0 / rn**3
    p7 = sim.J2_COEFF / rn**7
    rr = r[..., :, None] * r[..., None, :]
    diag = torch.diag_embed(p7 * t - sim.MU_EARTH * p3)
    cross = (rr * (3.0 * sim.MU_EARTH * p3 / rn2)[..., None]
             + (2.0 * p7)[..., None] * R * rr)
    tail = (7.0 * p7 / rn2)[..., None] * ((t * r)[..., :, None]
                                          * r[..., None, :])
    return diag + cross - tail


def deriv(x):
    return torch.cat([x[..., 3:6], accel(x[..., :3])], dim=-1)


def rk4_step(x, h):
    f1 = deriv(x)
    f2 = deriv(x + 0.5 * h * f1)
    f3 = deriv(x + 0.5 * h * f2)
    f4 = deriv(x + h * f3)
    return x + (h / 6.0) * ((f1 + 2.0 * f2) + 2.0 * f3 + f4)


def rk4_step_with_jacobian(x, h):
    eye = torch.eye(6, dtype=x.dtype, device=x.device)
    h6 = h[..., None]

    def fj(xx, M):
        Ja = accel_jacobian(xx[..., :3])
        return deriv(xx), torch.cat([M[..., 3:6, :], Ja @ M[..., 0:3, :]],
                                    dim=-2)

    f1, K1 = fj(x, eye.expand(*x.shape[:-1], 6, 6))
    f2, K2 = fj(x + 0.5 * h * f1, eye + 0.5 * h6 * K1)
    f3, K3 = fj(x + 0.5 * h * f2, eye + 0.5 * h6 * K2)
    f4, K4 = fj(x + h * f3, eye + h6 * K3)
    return (x + (h / 6.0) * ((f1 + 2.0 * f2) + 2.0 * f3 + f4),
            eye + (h6 / 6.0) * ((K1 + 2.0 * K2) + 2.0 * K3 + K4))


def hop_sizes(gaps, num_hops, max_substep):
    k = torch.arange(num_hops, dtype=gaps.dtype, device=gaps.device
                     ).reshape(-1, *([1] * gaps.dim()))
    full = torch.floor(gaps / max_substep)[None]
    rem = torch.remainder(gaps, max_substep)[None]
    return torch.where(k < full, torch.full_like(rem, max_substep),
                       torch.where(k == full, rem, torch.zeros_like(rem)))


def propagate_gaps(pos, vel, gaps, num_hops, max_substep, jacobian):
    """Each knot's [pos, vel] propagated by its own gap (and the 6x6
    transition Jacobian)."""
    x = torch.cat([pos, vel], dim=-1)
    J = torch.eye(6, dtype=x.dtype, device=x.device).expand(
        *x.shape[:-1], 6, 6)
    for h in hop_sizes(gaps.to(x.dtype), num_hops, max_substep):
        act = (h > 0)[..., None]
        if jacobian:
            xn, A = rk4_step_with_jacobian(x, h[..., None])
            J = torch.where(act[..., None], A @ J, J)
        else:
            xn = rk4_step(x, h[..., None])
        x = torch.where(act, xn, x)
    return x[..., :3], x[..., 3:6], J


def hop_schedule(gap: float, num_hops: int, max_substep: float):
    full = math.floor(gap / max_substep)
    rem = gap % max_substep
    hs = [float(max_substep)] * min(full, num_hops)
    if full < num_hops and rem > 0:
        hs.append(float(rem))
    return hs


def chain(x0: torch.Tensor, hs) -> torch.Tensor:
    """Sequential RK4 steps of one [pos, vel] state, in numpy on the
    host: (len(hs) + 1, 6) on x0's device."""
    out = sim.orbit_chain(x0.detach().cpu().numpy().astype(np.float64), hs)
    return torch.as_tensor(out, dtype=x0.dtype, device=x0.device)


# ---------------------------------------------------------------------------
# factors
# ---------------------------------------------------------------------------


def project(states, lm_xyz, ii, intr):
    st = states[..., ii, :]
    p = q_rotate_inverse(st[..., 3:7], lm_xyz - st[..., :3])
    fx, fy, cx, cy = intr.unbind(-1)
    d = 1.0 / torch.clamp(p[..., 2], min=0.1)
    return torch.stack([fx * p[..., 0] * d + cx, fy * p[..., 1] * d + cy],
                       dim=-1)


def _skew(p):
    px, py, pz = p.unbind(-1)
    z0 = torch.zeros_like(px)
    return torch.stack([torch.stack([z0, -pz, py], -1),
                        torch.stack([pz, z0, -px], -1),
                        torch.stack([-py, px, z0], -1)], -2)


def reprojection(states, lm_xyz, ii, intr):
    """Predicted pixels (M, 2) and the (M, 2, 9) tangent Jacobian."""
    st = states[ii]
    q = st[:, 3:7]
    p = q_rotate_inverse(q, lm_xyz - st[:, :3])
    fx, fy, cx, cy = intr.unbind(-1)
    X, Y, Z = p.unbind(-1)
    d = 1.0 / torch.clamp(Z, min=0.1)
    uv = torch.stack([fx * X * d + cx, fy * Y * d + cy], dim=-1)
    dd = torch.where(Z > 0.1, -d * d, torch.zeros_like(d))
    z = torch.zeros_like(X)
    duv = torch.stack([torch.stack([fx * d, z, fx * X * dd], -1),
                       torch.stack([z, fy * d, fy * Y * dd], -1)], -2)
    Jp = duv @ -q_to_matrix(q).transpose(-1, -2)
    Jr = duv @ (2.0 * _skew(p))
    return uv, torch.cat([Jp, Jr, torch.zeros_like(Jp)], dim=-1)


def _right_mult(q2):
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([torch.stack([w2, z2, -y2, x2], -1),
                        torch.stack([-z2, w2, x2, y2], -1),
                        torch.stack([y2, -x2, w2, z2], -1),
                        torch.stack([-x2, -y2, -z2, w2], -1)], -2)


def _dGqT_g(g):
    gx, gy, gz, gw = g.unbind(-1)
    return torch.stack([torch.stack([-gw, -gz, gy, gx], -1),
                        torch.stack([gz, -gw, -gx, gy], -1),
                        torch.stack([-gy, gx, -gw, gz], -1)], -2)


class Dyn(NamedTuple):
    res_pv: torch.Tensor
    res_q: torch.Tensor
    A: Optional[torch.Tensor] = None
    B: Optional[torch.Tensor] = None
    qgrad: Optional[torch.Tensor] = None
    Hq_diag: Optional[torch.Tensor] = None
    Hq_off: Optional[torch.Tensor] = None


def dynamics(states, gaps, cum_rot, vp, cfg: Config, num_hops: int,
             jacobian: bool) -> Dyn:
    """The dynamics factor between consecutive knots: position and
    weighted velocity residuals of the propagated knot, the attitude
    residual 1 - |<q_t c_t, q_t+1>|, and with `jacobian` the blocks of
    the normal equations they give (Gq-lift, no 1/2)."""
    N = states.shape[-2]
    dt, dev = states.dtype, states.device
    pos, q, vel = states[..., :3], states[..., 3:7], states[..., 7:10]
    p_pred, v_pred, J = propagate_gaps(pos, vel, gaps, num_hops,
                                       cfg.max_substep, jacobian)
    v1 = vp[..., None]
    res_pv = torch.cat([(p_pred[..., :-1, :] - pos[..., 1:, :]) * v1,
                        cfg.vel_coeff * (v_pred[..., :-1, :]
                                         - vel[..., 1:, :]) * v1], dim=-1)
    q_hat = q_mul(q[..., :-1, :], cum_rot[:-1])
    dq = (q_hat * q[..., 1:, :]).sum(-1)
    k = cfg.quat_coeff
    res_q = k * (1.0 - dq.abs()) * vp
    if not jacobian:
        return Dyn(res_pv, res_q)
    s = torch.sign(dq) * vp
    M = _right_mult(cum_rot[:-1])
    g_t = -k * s[..., None] * torch.einsum("tji,tj->ti", M, q[1:])
    g_t1 = -k * s[..., None] * q_hat
    g_amb = torch.zeros((N, 4), dtype=dt, device=dev)
    g_amb[:-1] += g_t
    g_amb[1:] += g_t1
    Gq = attitude_jacobian(q)
    qgrad = torch.zeros((N, 9), dtype=dt, device=dev)
    qgrad[:, 3:6] = torch.einsum("nij,ni->nj", Gq, g_amb)
    Hq_diag = torch.zeros((N, 9, 9), dtype=dt, device=dev)
    Hq_diag[:, 3:6, 3:6] = _dGqT_g(g_amb) @ Gq
    cross = -k * s[..., None, None] * M.transpose(-1, -2)
    Hq_off = torch.zeros((N - 1, 9, 9), dtype=dt, device=dev)
    Hq_off[:, 3:6, 3:6] = Gq[:-1].transpose(-1, -2) @ cross @ Gq[1:]
    W = torch.ones(6, dtype=dt, device=dev)
    W[3:] = cfg.vel_coeff
    A6 = W[None, :, None] * J[:-1] * v1[..., None]
    A = torch.zeros((N - 1, 6, 9), dtype=dt, device=dev)
    A[..., 0:3] = A6[..., 0:3]
    A[..., 6:9] = A6[..., 3:6]
    eye3 = torch.eye(3, dtype=dt, device=dev)
    B = torch.zeros((N - 1, 6, 9), dtype=dt, device=dev)
    B[:, 0:3, 0:3] = -eye3 * v1[..., None]
    B[:, 3:6, 6:9] = -cfg.vel_coeff * eye3 * v1[..., None]
    return Dyn(res_pv, res_q, A, B, qgrad, Hq_diag, Hq_off)


def cumulative_rotations(omega, knot_t):
    rots = q_exp(omega)
    ident = torch.zeros_like(rots[:1])
    ident[0, 3] = 1.0
    prefix = inclusive_scan(torch.cat([ident, rots]), q_mul)
    nxt = torch.cat([knot_t[1:], knot_t[-1:]])
    return q_normalize(q_mul(q_conj(prefix[knot_t]), prefix[nxt]))


# ---------------------------------------------------------------------------
# block-tridiagonal solves
# ---------------------------------------------------------------------------


def gj_solve(A, B):
    """Unpivoted Gauss-Jordan A x = B; A (..., k, k), B (..., k, r)."""
    k = A.shape[-1]
    M = torch.cat([A, B], dim=-1)
    for i in range(k):
        row = M[..., i, :] / M[..., i, i][..., None]
        M = M - M[..., :, i][..., None] * row[..., None, :]
        M[..., i, :] = row
    return M[..., k:]


def thomas(D, U, b):
    """Block Thomas: D (..., N, k, k), U (..., N-1, k, k), b (..., N, k)."""
    N, k = D.shape[-3], D.shape[-1]
    B = b[..., None]
    C_prev = torch.zeros_like(D[..., 0, :, :])
    d_prev = torch.zeros_like(B[..., 0, :, :])
    Cs, ds = [], []
    for t in range(N):
        Dt = D[..., t, :, :]
        Ut = U[..., t, :, :] if t < N - 1 else torch.zeros_like(Dt)
        if t > 0:
            LtT = U[..., t - 1, :, :].transpose(-1, -2)
            sol = gj_solve(Dt - LtT @ C_prev,
                           torch.cat([Ut, B[..., t, :, :] - LtT @ d_prev], -1))
        else:
            sol = gj_solve(Dt, torch.cat([Ut, B[..., t, :, :]], -1))
        C_prev, d_prev = sol[..., :k], sol[..., k:]
        Cs.append(C_prev)
        ds.append(d_prev)
    xs = [None] * N
    x = torch.zeros_like(d_prev)
    for t in reversed(range(N)):
        x = ds[t] - Cs[t] @ x
        xs[t] = x
    return torch.stack(xs, dim=-3)[..., 0]


def pcr(D, U, b):
    """Parallel cyclic reduction: D (B, N, k, k), U (B, N-1, k, k),
    b (B, N, k)."""
    Bn, N, k, _ = D.shape
    z = D.new_zeros(Bn, 1, k, k)
    Uw = torch.cat([U, z], dim=1)
    Lw = torch.cat([z, U.transpose(-1, -2)], dim=1)
    Dw, bw = D, b[..., None]

    def down(X, s):
        return torch.cat([torch.zeros_like(X[:, :s]), X[:, :-s]], dim=1)

    def up(X, s):
        return torch.cat([X[:, s:], torch.zeros_like(X[:, :s])], dim=1)

    s = 1
    while s < N:
        P = gj_solve(Dw, torch.cat([Lw, Uw, bw], dim=-1))
        PL, PU, Pb = P[..., :k], P[..., k:2 * k], P[..., 2 * k:]
        Dw = Dw - Lw @ down(PU, s) - Uw @ up(PL, s)
        bw = bw - Lw @ down(Pb, s) - Uw @ up(Pb, s)
        Lw, Uw = -(Lw @ down(PL, s)), -(Uw @ up(PU, s))
        s *= 2
    return gj_solve(Dw, bw)[..., 0]


def scaled_solve(D, U, b):
    """Jacobi-scaled solve of the damped systems D (K, N, 9, 9), U
    (K, N-1, 9, 9), b (K, N, 9)."""
    s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1),
                                     min=1e-30))
    Ds = D * s[..., :, :, None] * s[..., :, None, :]
    Us = U * s[..., :-1, :, None] * s[..., 1:, None, :]
    bs = b * s
    N = D.shape[-3]
    if N >= PCR_MIN_N:
        xs = pcr(Ds.reshape(-1, N, 9, 9), Us.reshape(-1, N - 1, 9, 9),
                 bs.reshape(-1, N, 9)).reshape(bs.shape)
    else:
        xs = thomas(Ds, Us, bs)
    return xs * s


# ---------------------------------------------------------------------------
# one LM iteration and a window's solve
# ---------------------------------------------------------------------------


class Problem(NamedTuple):
    gaps: torch.Tensor
    cum_rot: torch.Tensor
    lm_xyz: torch.Tensor
    uv: torch.Tensor
    conf: torch.Tensor
    ii: torch.Tensor
    obs_valid: torch.Tensor
    pair_valid: torch.Tensor
    intr: torch.Tensor


def robust_weights(r, conf, valid, it: int):
    alpha = min(max(1.0 - (2.0 * (it / 5.0) - 1.0), 1.0), 2.0)
    flat = r.abs().flatten()
    vm = valid[:, None].expand(r.shape).flatten() > 0
    order = torch.sort(torch.where(vm, flat, torch.full_like(flat, math.inf))
                       ).values
    n = int(vm.sum())
    last = flat.shape[0] - 1
    med = 0.5 * (order[min(max((n - 1) // 2, 0), last)]
                 + order[min(max(n // 2, 0), last)])
    c = torch.clamp(med, min=1e-12)
    if alpha >= 2.0 - 1e-9:
        w_el = torch.ones_like(r) / (c * c)
    else:
        w_el = (((r / c) ** 2 / max(abs(alpha - 2.0), 1e-12) + 1.0)
                ** (alpha / 2.0 - 1.0)) / (c * c)
    w = w_el.mean(-1) * valid
    w = w / torch.clamp(w.max(), min=1e-30)
    return w * conf * valid


def residual_mean(r_obs, r_pred, obs_valid, pair_valid, sigma, pred_dim):
    s = ((r_obs.abs() * obs_valid[:, None]).sum((-2, -1))
         + (r_pred.abs() * math.sqrt(sigma)).sum((-2, -1)))
    n = 2.0 * obs_valid.sum() + pred_dim * pair_valid.sum()
    return s / torch.clamp(n, min=1.0)


def lm_iteration(it: int, states, prob: Problem, lam0, cfg: Config,
                 num_hops: int, initialize: bool):
    """One robust LM iteration: (states, next λ, trial residual)."""
    dt, dev = states.dtype, states.device
    N = states.shape[0]
    uv, Jg = reprojection(states, prob.lm_xyz, prob.ii, prob.intr)
    dyn = dynamics(states, prob.gaps, prob.cum_rot, prob.pair_valid, cfg,
                   num_hops, True)
    r_obs = (prob.uv - uv) * prob.obs_valid[:, None]
    w = robust_weights(r_obs, prob.conf, prob.obs_valid, it)
    sigma = min(cfg.sigma_scale * (float(it) + 1.0) ** 2, cfg.sigma_max)
    res_pv, res_q, A, B, qgrad, Hd, Ho = dyn
    if initialize:
        res_pv, res_q, A, B, qgrad, Hd, Ho = (
            t * 0.0 for t in (res_pv, res_q, A, B, qgrad, Hd, Ho))
    JgW = Jg * w[:, None, None]
    D = torch.zeros((N, 9, 9), dtype=dt, device=dev).index_add_(
        0, prob.ii, JgW.transpose(-1, -2) @ Jg)
    D = D + sigma * Hd
    At, Bt = A.transpose(-1, -2), B.transpose(-1, -2)
    D[:-1] += sigma * (At @ A)
    D[1:] += sigma * (Bt @ B)
    U = sigma * (At @ B + Ho)
    g_obs = torch.zeros((N, 9), dtype=dt, device=dev).index_add_(
        0, prob.ii, (JgW.transpose(-1, -2) @ r_obs[..., None])[..., 0])
    g_dyn = torch.zeros((N, 9), dtype=dt, device=dev)
    g_dyn[:-1] += (At @ res_pv[..., None])[..., 0]
    g_dyn[1:] += (Bt @ res_pv[..., None])[..., 0]
    JTr = g_obs - sigma * g_dyn - sigma * qgrad
    pred_dim = 6.0 if initialize else 7.0
    if initialize:
        r_pred = torch.zeros((N - 1, 7), dtype=dt, device=dev)
    else:
        r_pred = torch.cat([res_pv, res_q[:, None]], -1)
    init_res = residual_mean(r_obs, r_pred * prob.pair_valid[:, None],
                             prob.obs_valid, prob.pair_valid, sigma,
                             pred_dim)

    def trial(st):
        r1 = (prob.uv - project(st, prob.lm_xyz, prob.ii, prob.intr)) \
            * prob.obs_valid[:, None] * w[:, None]
        if initialize:
            rp = torch.zeros(st.shape[:-2] + (N - 1, 7), dtype=dt,
                             device=dev)
        else:
            d1 = dynamics(st, prob.gaps, prob.cum_rot, prob.pair_valid, cfg,
                          num_hops, False)
            rp = torch.cat([d1.res_pv, d1.res_q[..., None]], -1) \
                * prob.pair_valid[:, None]
        return residual_mean(r1, rp, prob.obs_valid, prob.pair_valid, sigma,
                             pred_dim)

    K = cfg.batched_lambda
    lams = torch.cumprod(torch.cat([lam0.reshape(1), lam0.new_full(
        (K - 1,), cfg.lambda_growth)]), dim=0)
    eye = torch.eye(9, dtype=dt, device=dev)
    dx = scaled_solve(D + lams[:, None, None, None] * eye,
                      U.expand(K, N - 1, 9, 9), JTr.expand(K, N, 9))
    cand = torch.cat([states[:, :3] + dx[..., 0:3],
                      q_normalize(q_mul(states[:, 3:7], q_exp(dx[..., 3:6]))),
                      states[:, 7:10] + dx[..., 6:9]], dim=-1)
    trials = trial(cand)
    ks = torch.arange(K, device=dev)
    valid = (ks == 0) | (lams <= cfg.lambda_max)
    acc = valid & (trials < init_res)
    if bool(acc.any()):
        j = int(torch.argmax(acc.to(dt)))
    else:
        j = K - 1 - int(torch.argmax(valid.flip(0).to(dt)))
    lam_next = torch.clamp(torch.clamp(lams[j] * cfg.lambda_growth * 0.01,
                                       max=1e-1), min=1e-4)
    return cand[j], lam_next, trials[j]


def solve_window(st0, prob: Problem, lam_init: float, init_iters: int,
                 max_iters: int, cfg: Config, num_hops: int):
    """max_iters LM iterations, the first init_iters vision-only; the
    best-residual iterate after the init phase."""
    states = st0
    lam = torch.full((), lam_init, dtype=st0.dtype, device=st0.device)
    best, best_res = st0, math.inf
    for i in range(max_iters):
        states, lam, res = lm_iteration(i, states, prob, lam, cfg, num_hops,
                                        i < init_iters)
        r = float(res)
        if i == init_iters or r < best_res:
            best, best_res = states, r
    return best


def reproj_rms(states, prob: Problem):
    uv = project(states, prob.lm_xyz, prob.ii, prob.intr)
    w = prob.obs_valid
    d = torch.where((w > 0)[:, None], uv - prob.uv, torch.zeros_like(uv))
    r2 = torch.clamp((d * d).sum(-1), max=64.0 * 64.0)
    return float(torch.sqrt((r2 * w).sum() / torch.clamp(w.sum(), min=1.0)))


# ---------------------------------------------------------------------------
# the tail: shooting fits of the last window's knots
# ---------------------------------------------------------------------------


def _hop_plan(gaps: np.ndarray, num_hops: int, max_substep: float):
    hops, counts = [], [0]
    for g in gaps:
        hops += hop_schedule(float(g), num_hops, max_substep)
        counts.append(len(hops))
    return hops, np.asarray(counts, np.int64)


def _rollout(x0, plan):
    hops, idx = plan
    xs = chain(x0, hops)
    h = torch.as_tensor(np.asarray(hops), dtype=x0.dtype,
                        device=x0.device).reshape(-1, 1)
    _, A = rk4_step_with_jacobian(xs[:-1], h)
    P = inclusive_scan(A, lambda a, b: b @ a)
    P = torch.cat([torch.eye(6, dtype=x0.dtype, device=x0.device)[None], P])
    i = torch.as_tensor(idx, device=x0.device)
    return xs[i], P[i]


def _solve6(H, g):
    return torch.linalg.solve_ex(H, g[:, None])[0][:, 0]


def _mean_abs(r, w):
    return (r.abs() * w[:, None]).sum() / torch.clamp(2.0 * w.sum(), min=1.0)


def shoot6(states, plan, lm_xyz, uv, conf, ii, intr, iters: int = 20):
    """Gauss-Newton fit of the initial [pos, vel], attitudes held: the
    refined [pos, vel] at every knot, the fit's and the start's residual."""
    dt, dev = states.dtype, states.device
    q_fix = states[:, 3:7]
    x0 = torch.cat([states[0, :3], states[0, 7:10]])
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def residuals(x):
        xs, Ph = _rollout(x, plan)
        st = torch.cat([xs[:, :3], q_fix, xs[:, 3:]], dim=-1)
        p, J = reprojection(st, lm_xyz, ii, intr)
        return uv - p, J[:, :, 0:3] @ Ph[ii][:, 0:3, :], xs

    res0 = _mean_abs(residuals(x0)[0], conf)
    lam = torch.full((), 1e-8, dtype=dt, device=dev)
    best_x, best_res = x0, res0
    for _ in range(iters):
        r, Jm, _ = residuals(x0)
        res = _mean_abs(r, conf)
        take = res < best_res
        best_x = torch.where(take, x0, best_x)
        best_res = torch.where(take, res, best_res)
        JW = Jm * conf[:, None, None]
        H = JW.reshape(-1, 6).T @ Jm.reshape(-1, 6)
        g = JW.reshape(-1, 6).T @ r.reshape(-1)
        s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-30))
        xn = x0 + s * _solve6(H * s[:, None] * s[None, :] + lam * eye6, s * g)
        acc = _mean_abs(residuals(xn)[0], conf) < res
        x0 = torch.where(acc, xn, x0)
        lam = torch.where(acc, torch.clamp(lam * 0.3, min=1e-12), lam * 10.0)
    res_last = _mean_abs(residuals(x0)[0], conf)
    x_out = torch.where(res_last <= best_res, x0, best_x)
    return residuals(x_out)[2], torch.minimum(res_last, best_res), res0


def shoot9(states, plan, cum_rot, lm_xyz, uv, conf, ii, intr,
           att_sigma: float, iters: int = 24):
    """The fit on the rigid attitude chain: [pos, vel] and one initial
    attitude correction carried through the rate chain, with a weak
    prior on it."""
    dt, dev = states.dtype, states.device
    N = states.shape[0]
    x0 = torch.cat([states[0, :3], states[0, 7:10]])
    inv_s2 = 1.0 / att_sigma**2
    eye9 = torch.eye(9, dtype=dt, device=dev)
    ident = torch.zeros((1, 4), dtype=dt, device=dev)
    ident[0, 3] = 1.0
    C = inclusive_scan(torch.cat([ident, cum_rot[:-1]]), q_mul)
    Rt = q_to_matrix(C).transpose(-1, -2)
    q_chain = q_normalize(q_mul(states[0, 3:7].expand(N, 4), C))
    Rt_ii = Rt[ii]

    def residuals(th):
        xs, Ph = _rollout(th[:6], plan)
        eps = (Rt @ th[6:, None])[..., 0]
        q = q_normalize(q_mul(q_chain, q_exp(eps)))
        st = torch.cat([xs[:, :3], q, xs[:, 3:]], dim=-1)
        p, J = reprojection(st, lm_xyz, ii, intr)
        return uv - p, torch.cat([J[:, :, 0:3] @ Ph[ii][:, 0:3, :],
                                  J[:, :, 3:6] @ Rt_ii], dim=-1), st

    def obj(r, delta):
        return (0.5 * ((r ** 2) * conf[:, None]).sum()
                + 0.5 * inv_s2 * (delta ** 2).sum())

    res_in = _mean_abs(uv - reprojection(states, lm_xyz, ii, intr)[0], conf)
    th = torch.cat([x0, torch.zeros(3, dtype=dt, device=dev)])
    lam = torch.full((), 1e-8, dtype=dt, device=dev)
    bth, bobj = th, obj(residuals(th)[0], th[6:])
    for _ in range(iters):
        r, J, _ = residuals(th)
        f = obj(r, th[6:])
        take = f < bobj
        bth = torch.where(take, th, bth)
        bobj = torch.where(take, f, bobj)
        JW = J * conf[:, None, None]
        H = JW.reshape(-1, 9).T @ J.reshape(-1, 9)
        H[6:, 6:] += inv_s2 * eye9[:3, :3]
        g = JW.reshape(-1, 9).T @ r.reshape(-1)
        g[6:] += -inv_s2 * th[6:]
        s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-30))
        thn = th + s * _solve6(H * s[:, None] * s[None, :] + lam * eye9,
                               s * g)
        acc = obj(residuals(thn)[0], thn[6:]) < f
        th = torch.where(acc, thn, th)
        lam = torch.where(acc, torch.clamp(lam * 0.3, min=1e-12), lam * 10.0)
    th = torch.where(obj(residuals(th)[0], th[6:]) <= bobj, th, bth)
    r, _, st = residuals(th)
    return st, _mean_abs(r, conf), res_in


def refine_tail(states, gaps, cum_rot, lm_xyz, uv, conf, ii, intr,
                cfg: Config):
    """The rigid fit when finite and within tail_ratio of the input's
    residual, else the 6-dof fit when finite and improving, else the
    input."""
    N = states.shape[0]
    g = np.array(gaps, np.float64)
    g[N - 1:] = 0.0
    hops = int(np.ceil(max(g.max(), 1.0) / cfg.max_substep)) + 1
    plan = _hop_plan(g[:-1], hops, cfg.max_substep)
    st9, r9, r_in = shoot9(states, plan, cum_rot, lm_xyz, uv, conf, ii, intr,
                           cfg.tail_att_sigma)
    pv6, r6, r6_0 = shoot6(states, plan, lm_xyz, uv, conf, ii, intr)
    if bool(torch.isfinite(st9).all()) and float(r9) <= cfg.tail_ratio * max(
            float(r_in), 1e-6):
        return st9
    if bool(torch.isfinite(pv6).all()) and float(r6) <= float(r6_0):
        return torch.cat([pv6[:, :3], states[:, 3:7], pv6[:, 3:]], dim=-1)
    return states


# ---------------------------------------------------------------------------
# the stream
# ---------------------------------------------------------------------------


def propagate(state10, omega, length: int):
    """1 Hz RK4 of one knot over `length` steps, the attitude rolled with
    the rate rotations: (length + 1, 10)."""
    xs = chain(torch.cat([state10[:3], state10[7:10]]), [1.0] * length)
    q = state10[3:7]
    if length:
        prefix = inclusive_scan(q_exp(omega[:length]), q_mul)
        qs = torch.cat([q[None], q_mul(q.expand(length, 4), prefix)])
    else:
        qs = q[None]
    return torch.cat([xs[:, :3], qs, xs[:, 3:6]], dim=-1)


def _multi_pass(det_t, cfg: Config) -> bool:
    dt = np.unique(np.asarray(det_t, np.float64))
    if len(dt) < 2:
        return False
    passes = 1 + int((np.diff(dt) > 200.0).sum())
    return passes >= 2 and float(dt[-1] - dt[0]) >= cfg.budget_span_min_s


def stream(rows: np.ndarray, orbit: np.ndarray, seed: int,
           cfg: Config = Config(), device="cpu",
           dtype=torch.float64) -> Result:
    """Streaming orbit determination of the arc (rows, orbit) from the
    initial-noise seed, in `dtype` on `device` (conditioning in f64)."""
    dev = torch.device(device)
    f64 = torch.float64

    def t(a, dt=f64):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    rng = np.random.default_rng(seed)
    T = orbit.shape[0]
    graph = build_graph(np.asarray(rows, np.float64), T)
    vel_full = np.concatenate([np.diff(orbit, axis=0), np.zeros((1, 3))])
    q_full_t = nadir_quaternion(t(orbit))
    dq = q_normalize(q_mul(q_conj(q_full_t[:-1]), q_full_t[1:]))
    omega = torch.cat([q_log(dq), torch.zeros_like(dq[:1, :3])]).cpu().numpy()
    q_full = q_full_t.cpu().numpy()
    lm_xyz = lonlat_to_eci(t(graph.lonlat[:, 0]), t(graph.lonlat[:, 1]),
                           t(graph.frame)).cpu().numpy()
    ti = graph.time_idx
    gt = np.concatenate([orbit[ti], q_full[ti], vel_full[ti]], axis=1)
    intr = np.array(INTRINSICS)
    uvp = project(t(gt), t(lm_xyz), t(graph.ii, torch.int64),
                  t(intr)).cpu().numpy()
    err = np.linalg.norm(uvp - graph.uv, axis=-1)
    keep = ((uvp[:, 0] > 0) & (uvp[:, 1] > 0) & (uvp[:, 0] < 4700.0)
            & (uvp[:, 1] < 2600.0) & (err < 1000.0) & (graph.conf > 0.8))
    has = np.zeros(len(ti), bool)
    has[np.unique(graph.ii[keep])] = True
    keep_knot = has | (ti % KNOT_STRIDE == 0)
    ii = (np.cumsum(keep_knot) - 1)[graph.ii[keep]]
    uv, conf, lm_xyz = graph.uv[keep], graph.conf[keep], lm_xyz[keep]
    knot_t, gt = ti[keep_knot], gt[keep_knot]
    N = len(knot_t)

    pos0 = gt[:, :3] + rng.standard_normal((N, 3)) * cfg.noise_pos_km
    phi = q_log(t(gt[:, 3:7])).cpu().numpy()
    phi = phi + rng.standard_normal((N, 3)) * cfg.noise_ori_rad
    q0 = q_exp(t(phi)).cpu().numpy()
    vs = np.abs(gt[:, 7:10]).mean()
    vel0 = gt[:, 7:10] + rng.standard_normal((N, 3)) * vs * cfg.noise_vel_rel
    states0 = np.concatenate([pos0, q0, vel0], axis=1)
    gaps = np.concatenate([np.diff(knot_t), [0]]).astype(np.float64)
    cum_rot = cumulative_rotations(t(omega), t(knot_t, torch.int64)
                                   ).cpu().numpy()
    windows = split_windows(ii, knot_t)
    hops0 = max(cfg.num_hops, int(np.ceil(gaps.max() / cfg.max_substep)) + 1)
    later_iters = min(cfg.max_iters, max(cfg.max_iters_later,
                                         cfg.num_iters + 1))

    def problem(n, i_final, n_pad, m_pad):
        g = np.zeros(n_pad)
        g[:n] = gaps[:n]
        cr = np.zeros((n_pad, 4))
        cr[:, 3] = 1.0
        cr[:n] = cum_rot[:n]
        lx = np.zeros((m_pad, 3))
        lx[:i_final] = lm_xyz[:i_final]
        lu = np.zeros((m_pad, 2))
        lu[:i_final] = uv[:i_final]
        cf = np.zeros(m_pad)
        cf[:i_final] = conf[:i_final]
        iin = np.zeros(m_pad, np.int64)
        iin[:i_final] = ii[:i_final]
        ov = np.zeros(m_pad)
        ov[:i_final] = 1.0
        pv = np.zeros(max(n_pad - 1, 1))
        pv[:max(n - 1, 0)] = 1.0
        return Problem(t(g, dtype), t(cr, dtype), t(lx, dtype), t(lu, dtype),
                       t(cf, dtype), t(iin, torch.int64), t(ov, dtype),
                       t(pv, dtype), t(intr, dtype))

    errors, times = [], []
    cur = None
    trips = 0
    t_prev = 0
    for w, (t_final, i_final, seq_end) in enumerate(windows):
        if w == 0:
            win_states = states0[:t_final]
        else:
            span = int(knot_t[t_final - 1] - knot_t[t_prev - 1])
            om = omega[knot_t[t_prev - 1]:knot_t[t_final - 1]]
            path = propagate(t(cur[-1]), t(om), span).cpu().numpy()
            prop = path[knot_t[t_prev:t_final] - knot_t[t_prev - 1]]
            errors.append(np.linalg.norm(
                prop[:, :3] - gt[t_prev:t_final, :3], axis=-1)[:-1])
            times.append(knot_t[t_prev:t_final][:-1])
            win_states = np.concatenate([cur, prop], axis=0)
        iters = cfg.max_iters
        if w > 0 and _multi_pass(knot_t[ii[:i_final]], cfg):
            iters = later_iters
        hops = min(hops0, max(int(math.ceil(
            max(float(g) for g in gaps[:t_final]) / cfg.max_substep)), 1))
        n_pad = bucket(t_final, cfg.knot_bucket)
        m_pad = bucket(max(i_final, 1), cfg.obs_bucket, cfg.obs_bucket)
        st = np.zeros((n_pad, 10))
        st[:, 6] = 1.0
        st[:t_final] = win_states
        st0 = t(st, dtype)
        prob = problem(t_final, i_final, n_pad, m_pad)
        init_iters = cfg.init_iters if w == 0 else 0
        cands = []
        out = None
        for rung, lam0 in enumerate((cfg.lambda_init, 1e2)):
            o = solve_window(st0, prob, lam0, init_iters, iters, cfg, hops)
            r = (reproj_rms(o, prob) if bool(torch.isfinite(o).all())
                 else math.inf)
            if r <= cfg.recover_rms_px:
                out = o
                break
            if rung == 0:
                trips += 1
            if math.isfinite(r):
                cands.append((r, o))
        if out is None:
            out = min(cands, key=lambda c: c[0])[1] if cands else st0
        cur = out[:t_final].to(f64).cpu().numpy()
        t_prev = t_final
        errors.append(np.linalg.norm(cur[-1:, :3] - gt[t_final - 1:t_final,
                                                        :3], axis=-1))
        times.append(knot_t[t_final - 1:t_final])
        if seq_end and t_final < N:
            ref = refine_tail(
                t(cur, dtype), gaps[:t_final], t(cum_rot[:t_final], dtype),
                t(lm_xyz, dtype), t(uv, dtype), t(conf, dtype),
                t(ii, torch.int64), t(intr, dtype), cfg)
            cur = ref.to(f64).cpu().numpy()
            span = int(knot_t[-1] - knot_t[t_final - 1])
            om = omega[knot_t[t_final - 1]:knot_t[-1]]
            path = propagate(t(cur[-1]), t(om), span).cpu().numpy()
            prop = path[knot_t[t_final:] - knot_t[t_final - 1]]
            errors.append(np.linalg.norm(prop[:, :3] - gt[t_final:, :3],
                                         axis=-1))
            times.append(knot_t[t_final:])
    return Result(np.concatenate(errors), np.concatenate(times), cur,
                  knot_t[:t_prev], trips)
