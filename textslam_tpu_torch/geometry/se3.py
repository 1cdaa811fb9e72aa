"""SE(3) poses as packed [..., 7] = [qw qx qy qz tx ty tz] tensors, port of
textslam_tpu/geometry/se3.py.

Convention: `Tcw` maps world points into the camera frame,
p_c = R(q) p_w + t.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .quaternion import qconj, qmul, qnormalize, qrotate, qexp

Pose = Tuple[torch.Tensor, torch.Tensor]  # (q [...,4], t [...,3])


def identity(shape=(), device=None) -> torch.Tensor:
    p = torch.zeros(tuple(shape) + (7,), device=device)
    p[..., 0] = 1.0
    return p


def pack(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([q, t], dim=-1)


def unpack(T: torch.Tensor) -> Pose:
    return T[..., 0:4], T[..., 4:7]


def apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Transform points p [..., 3] by packed pose T [..., 7]."""
    q, t = unpack(T)
    return qrotate(q, p) + t


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """T = A ∘ B (apply B first): R = Ra Rb, t = Ra tb + ta."""
    qa, ta = unpack(A)
    qb, tb = unpack(B)
    q = qnormalize(qmul(qa, qb))
    t = qrotate(qa, tb) + ta
    q, t = _bcast_lead(q, t)
    return pack(q, t)


def inverse(T: torch.Tensor) -> torch.Tensor:
    q, t = unpack(T)
    qi = qconj(q)
    return pack(qi, -qrotate(qi, t))


def relative(T_aw: torch.Tensor, T_bw: torch.Tensor) -> torch.Tensor:
    """T_ab = T_aw ∘ T_bw^-1 — maps frame-b coords into frame a."""
    return compose(T_aw, inverse(T_bw))


def retract(T: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Apply 6-dof tangent update delta [..., 6] = (omega, dt): rotation on
    the manifold by left-multiplication, translation additively (the
    reference solver's 4-block quaternion + 3-block translation)."""
    q, t = unpack(T)
    qn = qnormalize(qmul(qexp(delta[..., 0:3]), q))
    qn, tn = _bcast_lead(qn, t + delta[..., 3:6])
    return pack(qn, tn)


def _bcast_lead(q: torch.Tensor, t: torch.Tensor):
    """Broadcast the leading axes of a (q, t) pair before packing."""
    lead = torch.broadcast_shapes(q.shape[:-1], t.shape[:-1])
    return q.expand(lead + (4,)), t.expand(lead + (3,))
