"""Batched two-view DLT triangulation + cheirality helpers, port of
textslam_tpu/geometry/triangulate.py: one batched SVD over all
correspondences.
"""

from __future__ import annotations

import torch

from . import se3
from .quaternion import qto_matrix

EPS = 1e-12


def _proj_matrix(T: torch.Tensor) -> torch.Tensor:
    """Packed pose [..., 7] -> normalized projection matrix [R|t] [..., 3, 4]."""
    q, t = se3.unpack(T)
    R = qto_matrix(q)
    return torch.cat([R, t[..., None]], dim=-1)


def triangulate(ray1: torch.Tensor, ray2: torch.Tensor, T1: torch.Tensor, T2: torch.Tensor) -> torch.Tensor:
    """DLT triangulation in world coords.

    ray1/ray2: unit-plane rays [..., 3] in cams 1/2; T1/T2 world->cam poses
    [..., 7] (broadcastable). Returns world points [..., 3].
    """
    P1 = _proj_matrix(T1)
    P2 = _proj_matrix(T2)
    x1, y1 = ray1[..., 0], ray1[..., 1]
    x2, y2 = ray2[..., 0], ray2[..., 1]
    rows = torch.broadcast_tensors(
        x1[..., None] * P1[..., 2, :] - P1[..., 0, :],
        y1[..., None] * P1[..., 2, :] - P1[..., 1, :],
        x2[..., None] * P2[..., 2, :] - P2[..., 0, :],
        y2[..., None] * P2[..., 2, :] - P2[..., 1, :],
    )
    A = torch.stack(rows, dim=-2)  # [..., 4, 4]
    # LAPACK refuses non-finite input where jnp.linalg.svd returns NaN:
    # solve such systems as zeros and give them NaN points
    bad = ~torch.isfinite(A).all(dim=-1).all(dim=-1)
    Vt = torch.linalg.svd(torch.where(bad[..., None, None], 0.0, A)).Vh
    X = Vt[..., 3, :]
    w = X[..., 3:4]
    P = X[..., 0:3] / torch.where(w.abs() < EPS, torch.full_like(w, EPS), w)
    return torch.where(bad[..., None], float("nan"), P)


def depths(p_world: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """z-coordinate of world points in camera frame of T (world->cam)."""
    return se3.apply(T, p_world)[..., 2]


def reproj_err2(p_world: torch.Tensor, T: torch.Tensor, uv: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """Squared pixel reprojection error of world points into camera T."""
    from .camera import project

    pred = project(se3.apply(T, p_world), fx, fy, cx, cy)
    d = pred - uv
    return (d * d).sum(dim=-1)


def parallax_cos(p_world: torch.Tensor, C1: torch.Tensor, C2: torch.Tensor) -> torch.Tensor:
    """cos of the parallax angle between the two viewing rays (CheckRT gate)."""
    v1 = p_world - C1
    v2 = p_world - C2
    n1 = torch.linalg.vector_norm(v1, dim=-1).clamp(min=EPS)
    n2 = torch.linalg.vector_norm(v2, dim=-1).clamp(min=EPS)
    return (v1 * v2).sum(dim=-1) / (n1 * n2)
