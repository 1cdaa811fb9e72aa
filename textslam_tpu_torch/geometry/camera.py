"""Pinhole camera projection helpers, port of textslam_tpu/geometry/camera.py.

Images are undistorted up front, so the working camera model downstream is a
pure pinhole.
"""

from __future__ import annotations

import torch

EPS = 1e-12


def project(p_cam: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """Camera-frame points [..., 3] -> pixels [..., 2]. No cheirality gating
    here; callers mask on z > 0 separately."""
    z = p_cam[..., 2:3]
    zc = torch.where(z.abs() < EPS, torch.sign(z) * EPS + (z == 0) * EPS, z)
    u = fx * p_cam[..., 0:1] / zc + cx
    v = fy * p_cam[..., 1:2] / zc + cy
    return torch.cat([u, v], dim=-1)


def unproject(uv: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """Pixels [..., 2] -> unit-plane rays [..., 3]."""
    m1 = (uv[..., 0] - cx) / fx
    m2 = (uv[..., 1] - cy) / fy
    return torch.stack([m1, m2, torch.ones_like(m1)], dim=-1)


def in_image(uv: torch.Tensor, width: int, height: int, margin: float = 0.0) -> torch.Tensor:
    """Validity mask [...] for pixels inside the image (optionally shrunk)."""
    u, v = uv[..., 0], uv[..., 1]
    return (
        (u >= margin) & (u <= width - 1 - margin) & (v >= margin) & (v <= height - 1 - margin)
    )


def project_jacobian(p_cam: torch.Tensor, fx, fy) -> torch.Tensor:
    """d(u,v)/d(p_cam): [..., 2, 3] analytic Jacobian of the pinhole map."""
    x, y = p_cam[..., 0], p_cam[..., 1]
    z = p_cam[..., 2]
    iz = 1.0 / torch.where(z.abs() < EPS, torch.full_like(z, EPS), z)
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    J = torch.stack(
        [fx * iz, zero, -fx * x * iz2, zero, fy * iz, -fy * y * iz2],
        dim=-1,
    )
    return J.reshape(p_cam.shape[:-1] + (2, 3))
