"""Zero-mean normalized cross-correlation gate for text observations, port
of textslam_tpu/ops/zncc.py (CheckZNCC: a text object is only observed in a
frame if the ZNCC of its reference box pixels exceeds zncc_min)."""

from __future__ import annotations

import torch

from .interp import bilinear


def zncc(a: torch.Tensor, b: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked ZNCC over the last axis. a, b, valid: [..., N] -> [...]."""
    vf = valid.to(a.dtype)
    n = vf.sum(-1).clamp(min=1)
    am = (a * vf).sum(-1) / n
    bm = (b * vf).sum(-1) / n
    az = (a - am[..., None]) * vf
    bz = (b - bm[..., None]) * vf
    num = (az * bz).sum(-1)
    den = torch.sqrt((az * az).sum(-1) * (bz * bz).sum(-1)).clamp(min=1e-9)
    return num / den


def zncc_gate(ref_inten: torch.Tensor, ref_valid: torch.Tensor, img: torch.Tensor, uv: torch.Tensor):
    """ZNCC between stored reference intensities [..., N] and the samples of
    img at uv [..., N, 2]. Returns (score [...], n_valid [...])."""
    cur, ok = bilinear(img, uv)
    v = ref_valid & ok
    return zncc(ref_inten, cur, v), v.sum(-1)
