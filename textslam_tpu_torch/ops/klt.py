"""Batched pyramidal Lucas-Kanade optical flow, port of textslam_tpu/ops/klt.py.

Per level (coarse to fine): an 11x11 patch gather for every feature, the
2x2 normal matrix of its template gradients, then a fixed number of
Gauss-Newton updates. The JAX version's lax.fori_loop is a Python loop
over the batch of all features; the 2x2 solve is written in closed form
(one elementwise expression per feature instead of a batched LU).
"""

from __future__ import annotations

import numpy as np
import torch

from .interp import bilinear

PATCH_R = 5  # 11x11 window

_DY, _DX = np.mgrid[-PATCH_R : PATCH_R + 1, -PATCH_R : PATCH_R + 1]
_OFFS = np.stack([_DX, _DY], -1).reshape(-1, 2).astype(np.float32)  # [P2, 2]


def _solve2(G: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """G^-1 b for batched 2x2 G [N, 2, 2], b [N, 2]."""
    a, c, d, e = G[:, 0, 0], G[:, 0, 1], G[:, 1, 0], G[:, 1, 1]
    det = a * e - c * d
    return torch.stack([e * b[:, 0] - c * b[:, 1], a * b[:, 1] - d * b[:, 0]], dim=-1) / det[:, None]


def lk_level(img_I, grad_I, img_J, uv_I, uv_J, valid, n_iters: int = 10):
    """One pyramid level of LK for all features.

    img_I/grad_I: template intensity [H, W] and gradients [H, W, 2]; img_J:
    target intensity; uv_I [N, 2] feature positions in the template; uv_J
    [N, 2] current estimates in the target. Returns (uv_J', valid')."""
    offs = torch.as_tensor(_OFFS, device=img_I.device)
    pos_i = uv_I[:, None, :] + offs  # [N, P2, 2]
    Ivals, ok_i = bilinear(img_I, pos_i)
    gx, _ = bilinear(grad_I[..., 0], pos_i)
    gy, _ = bilinear(grad_I[..., 1], pos_i)
    g = torch.stack([gx, gy], dim=-1) / 8.0  # sobel -> dI/dpx
    G = g.transpose(1, 2) @ g + 1e-6 * torch.eye(2, device=g.device)
    det_ok = (G[:, 0, 0] * G[:, 1, 1] - G[:, 0, 1] * G[:, 1, 0]) > 1e-6
    d = torch.zeros_like(uv_J)
    for _ in range(n_iters):
        Jvals, ok_j = bilinear(img_J, (uv_J + d)[:, None, :] + offs)
        e = (Ivals - Jvals) * ok_i * ok_j
        b = (g * e[..., None]).sum(dim=1)
        d = d + _solve2(G, b)
    new_p = uv_J + d
    Jv, okj = bilinear(img_J, new_p[:, None, :] + offs)
    resid = (Ivals - Jv).abs().mean(dim=-1)
    H, W = img_J.shape
    inb = ((new_p[:, 0] >= PATCH_R) & (new_p[:, 0] < W - PATCH_R)
           & (new_p[:, 1] >= PATCH_R) & (new_p[:, 1] < H - PATCH_R))
    return new_p, valid & det_ok & inb & (resid < 32.0) & okj.all(dim=-1)


def klt_track(pyr_I, grads_I, pyr_J, uv: torch.Tensor, valid: torch.Tensor,
              levels=(3, 2, 1, 0), n_iters: int = 10):
    """Coarse-to-fine track of features uv (template level-0 px) from
    pyramid I to pyramid J (per-level tuples as from ops.pyramid.build_pyramid).
    Coarse levels refine the guess without invalidating. Returns
    (uv_J [N, 2] level-0 px, valid)."""
    guess = uv / (2.0 ** levels[0])
    v = valid
    for l in levels:
        uv_j, v_l = lk_level(pyr_I[l], grads_I[l], pyr_J[l], uv / 2.0 ** l, guess, v,
                             n_iters=n_iters)
        if l != levels[-1]:
            guess = uv_j * 2.0
        else:
            v = v & v_l
    return uv_j * (2.0 ** levels[-1]), v
