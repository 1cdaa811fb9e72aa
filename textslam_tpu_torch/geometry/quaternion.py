"""Quaternion algebra (w, x, y, z convention), port of
textslam_tpu/geometry/quaternion.py.

Quaternions are `[..., 4]` float32 tensors; every op broadcasts over the
leading axes.
"""

from __future__ import annotations

import torch

EPS = 1e-12


def qidentity(shape=(), device=None) -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), device=device)
    q[..., 0] = 1.0
    return q


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp(min=EPS)


def qmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def qconj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def qrotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v [..., 3] by quaternions q [..., 4] (R(q) @ v)."""
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    # v' = v + 2 qw (qv x v) + 2 qv x (qv x v)
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


def qto_matrix(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] -> [..., 3, 3] rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def qfrom_matrix(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] quaternion (w >= 0). Branchless Shepperd."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.sqrt((1.0 + tr).clamp(min=0.0)) / 2.0
    qx = torch.sqrt((1.0 + m00 - m11 - m22).clamp(min=0.0)) / 2.0
    qy = torch.sqrt((1.0 - m00 + m11 - m22).clamp(min=0.0)) / 2.0
    qz = torch.sqrt((1.0 - m00 - m11 + m22).clamp(min=0.0)) / 2.0
    qx = torch.copysign(qx, m21 - m12)
    qy = torch.copysign(qy, m02 - m20)
    qz = torch.copysign(qz, m10 - m01)
    return qnormalize(torch.stack([qw, qx, qy, qz], dim=-1))


def qexp(omega: torch.Tensor) -> torch.Tensor:
    """so(3) tangent [..., 3] -> unit quaternion; rotates by angle |omega|
    about omega/|omega|. Series form near 0, as in the JAX package."""
    sq = (omega * omega).sum(dim=-1, keepdim=True)
    small = sq < 1e-12
    sq_safe = torch.where(small, torch.ones_like(sq), sq)
    theta = torch.sqrt(sq_safe)
    half = 0.5 * theta
    k = torch.where(small, 0.5 - sq / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - sq / 8.0, torch.cos(half))
    return torch.cat([w, k * omega], dim=-1)


def qlog(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> so(3) tangent [..., 3] (inverse of qexp)."""
    q = torch.where(q[..., 0:1] < 0, -q, q)  # take w>=0 branch
    w = q[..., 0:1].clamp(-1.0, 1.0)
    v = q[..., 1:4]
    sq = (v * v).sum(dim=-1, keepdim=True)
    small = sq < 1e-12
    vn = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    theta = 2.0 * torch.atan2(vn, w)
    k = torch.where(small, 2.0 / w.clamp(min=EPS), theta / vn)
    return k * v


def qretract(q: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Manifold retraction: apply tangent update delta [..., 3] on the left."""
    return qnormalize(qmul(qexp(delta), q))
