"""Scalar-last quaternion algebra on torch tensors (port of
vinsat_tpu/core/quat.py).

Convention: q = [x, y, z, w] (scalar LAST).  Every function broadcasts over
leading batch dimensions.  The tangent lift `attitude_jacobian` keeps the
reference's convention WITHOUT the 1/2 factor; the factor Jacobians and the
retraction depend on it.
"""
from __future__ import annotations

import torch


def normalize(q, eps: float = 0.0):
    """Unit-normalize a quaternion along the last axis."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / (n + eps)


def multiply(q1, q2):
    """Hamilton product q1 ⊗ q2, scalar-last."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def conjugate(q):
    """Quaternion conjugate [-x, -y, -z, w]."""
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def exp(phi):
    """Axis-angle tangent vector -> unit quaternion, with the same
    small-angle Taylor branches as the JAX version."""
    t2 = (phi * phi).sum(-1, keepdim=True)
    small = t2 < 1e-12
    safe_t2 = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(safe_t2)
    sinc_half = torch.where(small, 0.5 - t2 / 48.0,
                            torch.sin(theta / 2.0) / theta)
    w = torch.where(small, 1.0 - t2 / 8.0, torch.cos(theta / 2.0))
    return torch.cat([phi * sinc_half, w], dim=-1)


def log(q):
    """Unit quaternion -> axis-angle tangent vector."""
    q = torch.clamp(normalize(q), -1.0, 1.0)
    w = torch.clamp(q[..., 3], -1.0, 1.0)
    theta = 2.0 * torch.arccos(w)
    s = torch.sin(theta / 2)
    tiny = s.abs() < 1e-12
    safe_s = torch.where(tiny, torch.ones_like(s), s)
    out = q[..., :3] / safe_s[..., None] * theta[..., None]
    return torch.where(tiny[..., None], 2.0 * q[..., :3], out)


def rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q: R(q) @ v."""
    qn = normalize(q)
    vq = torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)
    return multiply(qn, multiply(vq, conjugate(qn)))[..., :3]


def rotate_inverse(q, v):
    """Rotate v by the inverse rotation: R(q)^T @ v."""
    qn = normalize(q)
    vq = torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)
    return multiply(conjugate(qn), multiply(vq, qn))[..., :3]


def to_matrix(q):
    """Unit quaternion -> 3x3 rotation matrix."""
    x, y, z, w = normalize(q).unbind(-1)
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - z * w)
    r02 = 2 * (x * z + y * w)
    r10 = 2 * (x * y + z * w)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - x * w)
    r20 = 2 * (x * z - y * w)
    r21 = 2 * (y * z + x * w)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def from_matrix(R):
    """3x3 rotation matrix -> scalar-last unit quaternion (Shepperd's method:
    the numerically best of the four candidates, branch-free)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw = torch.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20],
                     dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21],
                     dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22],
                     dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 cand, wxyz)
    diag = torch.stack([tr, m00, m11, m22], dim=-1)
    best = torch.argmax(diag, dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q_wxyz = torch.gather(cands, -2, idx)[..., 0, :]
    q = torch.cat([q_wxyz[..., 1:], q_wxyz[..., :1]], dim=-1)
    return normalize(q)


def attitude_jacobian(q):
    """Tangent-lift matrix Gq (4x3), scalar-last, reference convention (no
    1/2 factor)."""
    x, y, z, w = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([w, -z, y], dim=-1),
            torch.stack([z, w, -x], dim=-1),
            torch.stack([-y, x, w], dim=-1),
            torch.stack([-x, -y, -z], dim=-1),
        ],
        dim=-2,
    )


def box_plus(q, phi):
    """Retraction: q ⊞ phi = normalize(q ⊗ exp(phi))."""
    return normalize(multiply(q, exp(phi)))


def omega_from_sequence(q_seq, dt):
    """Finite-difference body rates: omega_k = log(q_k* ⊗ q_{k+1}) / dt,
    final entry zero-padded."""
    dq = normalize(multiply(conjugate(q_seq[:-1]), q_seq[1:]))
    omega = log(dq) / dt
    return torch.cat([omega, torch.zeros_like(omega[:1])], dim=0)
