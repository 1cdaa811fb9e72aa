"""Separable image filtering, port of textslam_tpu/ops/pyramid.py.

Only the REFLECT_101 separable filter that ORB's descriptor blur uses is
ported with the scene-only slice; the x2 direct-alignment pyramid and its
Sobel gradients feed text residuals only and arrive with the text slice.

Layout: images are [H, W] float32 in [0, 255].
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _sep_conv2d_same(img: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """Separable symmetric filter with REFLECT_101 border (OpenCV default).

    Taps are summed in the same order as the JAX version (rows, then
    columns, tap 0 first), so float32 results agree term by term."""
    r = len(k) // 2
    H, W = img.shape
    pad = F.pad(img[None, None], (r, r, r, r), mode="reflect")[0, 0]
    taps = [float(v) for v in np.asarray(k, np.float32)]
    x = 0
    for i, kv in enumerate(taps):
        x = x + kv * pad[:, i : i + W]
    y = 0
    for i, kv in enumerate(taps):
        y = y + kv * x[i : i + H, :]
    return y
