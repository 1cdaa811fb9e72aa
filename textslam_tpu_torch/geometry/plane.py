"""Planar text-object parameterization theta in R^3, port of
textslam_tpu/geometry/plane.py.

A text object is a 3D plane stored in its host keyframe: for an in-box
pixel with unit-plane ray m = (m1, m2, 1), the inverse depth is
rho = 1/z = -m^T theta, i.e. theta^T p + 1 = 0 in host coordinates.

All functions broadcast over leading batch dims. The 3x3 solves use
torch.linalg.solve_ex, which returns non-finite values for a singular
system instead of raising, as jnp.linalg.solve does.
"""

from __future__ import annotations

import torch

from . import se3
from .quaternion import qconj, qrotate

EPS = 1e-12


def ray_from_pixel(uv: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """Pixel [..., 2] -> unit-plane ray [..., 3] = ((u-cx)/fx, (v-cy)/fy, 1)."""
    m1 = (uv[..., 0] - cx) / fx
    m2 = (uv[..., 1] - cy) / fy
    return torch.stack([m1, m2, torch.ones_like(m1)], dim=-1)


def inv_depth(ray: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """rho = -m^T theta for rays [..., 3] against plane theta [..., 3]."""
    return -(ray * theta).sum(dim=-1)


def backproject(ray: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Host-frame 3D point of a ray on the plane: p_r = m / rho."""
    return ray / inv_depth(ray, theta)[..., None].clamp(min=EPS)


def project_to_target(ray: torch.Tensor, theta: torch.Tensor, T_cr: torch.Tensor) -> torch.Tensor:
    """Plane projection host->target: p_c = R_cr (m / rho) + t_cr."""
    return se3.apply(T_cr, backproject(ray, theta))


def transform_theta(theta: torch.Tensor, T_rw: torch.Tensor) -> torch.Tensor:
    """Re-express the plane hosted in frame r in the frame T_rw maps from:
    (theta_w, d_w) = T_rw^T (theta_r, 1), divided by d_w."""
    q, t = se3.unpack(T_rw)
    n_w = qrotate(qconj(q), theta)
    d_w = (t * theta).sum(dim=-1) + 1.0
    return n_w / d_w[..., None]


def plane_normal_world(theta: torch.Tensor, T_rw: torch.Tensor) -> torch.Tensor:
    """Unit world-frame normal of a plane hosted in frame r (T_rw = host Tcw)."""
    th_w = transform_theta(theta, T_rw)
    return th_w / torch.linalg.norm(th_w, dim=-1, keepdim=True).clamp(min=EPS)


def view_cos(theta: torch.Tensor, T_rw: torch.Tensor, cam_center_w: torch.Tensor,
             point_w: torch.Tensor) -> torch.Tensor:
    """|cos| between the plane normal and the viewing ray (CheckOrientation)."""
    n = plane_normal_world(theta, T_rw)
    v = cam_center_w - point_w
    v = v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp(min=EPS)
    return (n * v).sum(dim=-1).abs()


def solve_theta_3pt(rays: torch.Tensor, rhos: torch.Tensor) -> torch.Tensor:
    """Closed-form theta from 3 (ray, rho) constraints: -[m1;m2;m3] theta = rho.
    rays [..., 3, 3], rhos [..., 3] -> theta [..., 3]."""
    sol, _ = torch.linalg.solve_ex(-rays, rhos[..., None])
    return sol[..., 0]


def fit_theta_lstsq(rays: torch.Tensor, rhos: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted least-squares theta from N (ray, rho) pairs, -rays^T theta = rho.
    rays [..., N, 3], rhos [..., N], w [..., N] -> [..., 3]."""
    A = -rays
    Aw = A * w[..., None]
    AtA = Aw.transpose(-1, -2) @ A + 1e-9 * torch.eye(3, device=rays.device)
    Atb = (Aw * rhos[..., None]).sum(dim=-2)
    sol, _ = torch.linalg.solve_ex(AtA, Atb[..., None])
    return sol[..., 0]
