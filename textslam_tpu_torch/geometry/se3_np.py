"""Host-side numpy mirror of geometry.se3 for single-pose glue math.

A copy of `textslam_tpu/geometry/se3_np.py` (numpy only). The tracker and
mapper compose, invert and apply individual [7]-vector poses
([qw qx qy qz tx ty tz], Tcw convention) as bookkeeping between device
calls; a device round-trip per 7-element operation would cost a launch and
a synchronising readback for nanoseconds of math. Batched pose math stays in
geometry.se3.
"""

from __future__ import annotations

import numpy as np

EPS = 1e-12


def qnormalize(q: np.ndarray) -> np.ndarray:
    return q / np.linalg.norm(q, axis=-1, keepdims=True).clip(EPS)


def qmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def qconj(q: np.ndarray) -> np.ndarray:
    return q * np.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def qrotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * np.cross(qv, v)
    return v + qw * t + np.cross(qv, t)


def qto_matrix(q: np.ndarray) -> np.ndarray:
    """[..., 4] -> [..., 3, 3] rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = np.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def unproject(uv: np.ndarray, fx, fy, cx, cy) -> np.ndarray:
    """Pixel [..., 2] -> unit-plane ray [..., 3] (geometry.camera.unproject twin)."""
    m1 = (uv[..., 0] - cx) / fx
    m2 = (uv[..., 1] - cy) / fy
    return np.stack([m1, m2, np.ones_like(m1)], axis=-1)


def project(p: np.ndarray, fx, fy, cx, cy) -> np.ndarray:
    """Camera points [..., 3] -> pixels [..., 2] (geometry.camera.project twin)."""
    z = p[..., 2]
    zc = np.where(np.abs(z) < EPS, np.sign(z) * EPS + (z == 0) * EPS, z)
    return np.stack(
        [fx * p[..., 0] / zc + cx, fy * p[..., 1] / zc + cy], axis=-1)


def identity(shape=()) -> np.ndarray:
    p = np.zeros(shape + (7,), dtype=np.float32)
    p[..., 0] = 1.0
    return p


def apply(T: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Transform points p [..., 3] by packed pose(s) T [..., 7]."""
    return qrotate(T[..., 0:4], p) + T[..., 4:7]


def compose(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """T = A ∘ B (apply B first): R = Ra Rb, t = Ra tb + ta."""
    qa, ta = A[..., 0:4], A[..., 4:7]
    qb, tb = B[..., 0:4], B[..., 4:7]
    return np.concatenate(
        [qnormalize(qmul(qa, qb)), qrotate(qa, tb) + ta], axis=-1)


def inverse(T: np.ndarray) -> np.ndarray:
    q, t = T[..., 0:4], T[..., 4:7]
    qi = qconj(q)
    return np.concatenate([qi, -qrotate(qi, t)], axis=-1)


def relative(T_aw: np.ndarray, T_bw: np.ndarray) -> np.ndarray:
    """T_ab = T_aw ∘ T_bw^-1 — maps frame-b coords into frame a."""
    return compose(T_aw, inverse(T_bw))
