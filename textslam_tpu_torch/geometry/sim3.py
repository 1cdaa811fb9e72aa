"""Sim(3) helpers, port of textslam_tpu/geometry/sim3.py.

Only `skew` is ported with the scene-only slice (the BA Jacobians use it);
the Sim(3) group ops arrive with loop closing.
"""

from __future__ import annotations

import torch


def skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))
