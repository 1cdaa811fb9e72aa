"""Image pyramid + gradient kernels, port of textslam_tpu/ops/pyramid.py.

The x2 direct-alignment pyramid (cv::pyrDown: 5x5 Gaussian then 2x
decimation) with 3x3 Sobel gradients per level, and the REFLECT_101
separable filter that both it and ORB's descriptor blur use.

Layout: images are [H, W] float32 in [0, 255]. `pack_pyramid` stores all
levels in one [L, Hmax, Wmax, 3] (intensity, sobel-x, sobel-y) tensor with
the true per-level extents on the host; a level slice keeps its pixels'
three channels contiguous, which is the layout the region-sampler kernel
(ops.patch_sample) reads in place.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# cv::pyrDown kernel: outer([1,4,6,4,1]/16)
_GAUSS5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0


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


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown equivalent: Gaussian blur then take even rows/cols."""
    return _sep_conv2d_same(img, _GAUSS5)[::2, ::2]


def sobel(img: torch.Tensor):
    """3x3 Sobel gradients (raw, unscaled), REFLECT_101 borders."""
    H, W = img.shape
    p = F.pad(img[None, None], (1, 1, 1, 1), mode="reflect")[0, 0]
    dx = p[:, 2 : W + 2] - p[:, 0:W]  # [H+2, W]
    gx = dx[0:H, :] + 2.0 * dx[1 : H + 1, :] + dx[2 : H + 2, :]
    dy = p[2 : H + 2, :] - p[0:H, :]  # [H, W+2]
    gy = dy[:, 0:W] + 2.0 * dy[:, 1 : W + 1] + dy[:, 2 : W + 2]
    return gx, gy


def build_pyramid(img: torch.Tensor, levels: int = 8):
    """The x2 intensity pyramid + per-level Sobel gradients: (images,
    grads), tuples of per-level [H_l, W_l] and [H_l, W_l, 2] tensors."""
    imgs = [img.float()]
    for _ in range(1, levels):
        imgs.append(pyr_down(imgs[-1]))
    grads = tuple(torch.stack(sobel(im), dim=-1) for im in imgs)
    return tuple(imgs), grads


def pack_pyramid(imgs, grads, pad_to=None):
    """Pack per-level arrays into one padded [L, Hmax, Wmax, 3] tensor.

    Returns {"data": tensor, "shapes": [L, 2] int32 numpy of the true
    (H, W) per level}. Levels beyond their true extent are zero."""
    L = len(imgs)
    Hmax, Wmax = imgs[0].shape if pad_to is None else pad_to
    data = torch.zeros((L, Hmax, Wmax, 3), dtype=torch.float32, device=imgs[0].device)
    shapes = np.zeros((L, 2), dtype=np.int32)
    for l, (im, g) in enumerate(zip(imgs, grads)):
        h, w = im.shape
        shapes[l] = (h, w)
        data[l, :h, :w, 0] = im
        data[l, :h, :w, 1:3] = g
    return {"data": data, "shapes": shapes}
