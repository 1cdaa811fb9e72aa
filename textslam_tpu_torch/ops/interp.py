"""Bilinear sampling, port of textslam_tpu/ops/interp.py.

Values outside the image return 0 with a False validity mask, so padded
residual slots die cleanly. Corner indices are clamped before the gather,
as in the JAX version (XLA clamps out-of-range gathers; torch raises).
"""

from __future__ import annotations

import torch


def _corners(u: torch.Tensor, v: torch.Tensor, w, h, W: int, H: int):
    """Clamped integer corner (u0, v0) and fractions (du, dv) of samples
    clipped to the valid extent [0, w-1] x [0, h-1] of an H x W buffer."""
    u = u.clamp(0.0, w - 1)
    v = v.clamp(0.0, h - 1)
    u0 = torch.floor(u).long().clamp(0, W - 2)
    v0 = torch.floor(v).long().clamp(0, H - 2)
    return u0, v0, u - u0, v - v0


def _lerp(i00, i01, i10, i11, du, dv):
    top = i00 + du * (i01 - i00)
    bot = i10 + du * (i11 - i10)
    return top + dv * (bot - top)


def bilinear(img: torch.Tensor, uv: torch.Tensor, valid_shape=None):
    """Sample img [H, W] or [H, W, C] at uv [..., 2] (u=x=col, v=y=row).

    Returns (values [..., (C)], mask [...]); mask False outside
    [0, W-1]x[0, H-1] (or outside `valid_shape=(h, w)` for packed padded
    levels), and such samples are exactly 0."""
    H, W = img.shape[0], img.shape[1]
    h = H if valid_shape is None else valid_shape[0]
    w = W if valid_shape is None else valid_shape[1]
    u, v = uv[..., 0], uv[..., 1]
    mask = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
    u0, v0, du, dv = _corners(u, v, w, h, W, H)
    if img.dim() == 3:
        du, dv = du[..., None], dv[..., None]
    out = _lerp(img[v0, u0], img[v0, u0 + 1], img[v0 + 1, u0], img[v0 + 1, u0 + 1], du, dv)
    m = mask[..., None] if img.dim() == 3 else mask
    return torch.where(m, out, torch.zeros_like(out)), mask


def bilinear_packed(pyr_data: torch.Tensor, pyr_shapes, level: int, uv: torch.Tensor):
    """Sample a packed pyramid [L, Hmax, Wmax, 3] (ops.pyramid.pack_pyramid)
    at one level; pyr_shapes [L, 2] holds the true (h, w) per level.
    Returns (intensity, gx, gy, mask)."""
    h, w = int(pyr_shapes[level][0]), int(pyr_shapes[level][1])
    vals, mask = bilinear(pyr_data[level], uv, valid_shape=(h, w))
    return vals[..., 0], vals[..., 1], vals[..., 2], mask


def bilinear_stack(imgs: torch.Tensor, k, uv: torch.Tensor):
    """Bilinear-sample image k of a stack imgs [K, H, W] or [K, H, W, C] at
    uv [..., 2]; k broadcasts against uv[..., 0]. The stack index joins the
    gather, so no per-row image copy is made."""
    H, W = imgs.shape[1], imgs.shape[2]
    u, v = uv[..., 0], uv[..., 1]
    mask = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    u0, v0, du, dv = _corners(u, v, W, H, W, H)
    if imgs.dim() == 4:
        du, dv = du[..., None], dv[..., None]
    out = _lerp(imgs[k, v0, u0], imgs[k, v0, u0 + 1], imgs[k, v0 + 1, u0],
                imgs[k, v0 + 1, u0 + 1], du, dv)
    m = mask[..., None] if imgs.dim() == 4 else mask
    return torch.where(m, out, torch.zeros_like(out)), mask


PATCH = 8  # patch_bilinear_stack's patch: the +-2 px pattern, bilinear +1, margin


def patch_bilinear_stack(imgs: torch.Tensor, k: torch.Tensor, center_uv: torch.Tensor,
                         uv: torch.Tensor):
    """Bilinear sampling of clustered points through one 8x8 patch per
    feature (the JAX CPU path of the text sampler).

    imgs [K, H, W, C]; k [F] image indices; center_uv [F, 2] cluster
    centers; uv [F, S, 2] sample positions. Returns (vals [F, S, C],
    mask [F, S]); samples outside the patch or the image are masked to 0."""
    K, H, W, C = imgs.shape
    Fn, S, _ = uv.shape
    ox = (torch.floor(center_uv[:, 0]) - 3).long().clamp(0, W - PATCH)
    oy = (torch.floor(center_uv[:, 1]) - 3).long().clamp(0, H - PATCH)
    off = torch.arange(PATCH, device=imgs.device)
    rows = (oy[:, None] + off)[:, :, None]
    cols = (ox[:, None] + off)[:, None, :]
    patches = imgs[k[:, None, None], rows, cols]  # [F, PS, PS, C]

    u, v = uv[..., 0], uv[..., 1]
    in_img = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    pu = u - ox[:, None].to(u.dtype)
    pv = v - oy[:, None].to(v.dtype)
    in_patch = (pu >= 0) & (pu <= PATCH - 1) & (pv >= 0) & (pv <= PATCH - 1)
    mask = in_img & in_patch
    u0, v0, du, dv = _corners(pu, pv, PATCH, PATCH, PATCH, PATCH)
    cols_i = torch.arange(PATCH, device=imgs.device)
    au = (cols_i == u0[..., None]) * (1.0 - du[..., None]) + (cols_i == u0[..., None] + 1) * du[..., None]
    av = (cols_i == v0[..., None]) * (1.0 - dv[..., None]) + (cols_i == v0[..., None] + 1) * dv[..., None]
    wgt = av[..., :, None] * au[..., None, :]  # [F, S, PS, PS]
    vals = torch.bmm(wgt.reshape(Fn, S, PATCH * PATCH), patches.reshape(Fn, PATCH * PATCH, C))
    return torch.where(mask[..., None], vals, torch.zeros_like(vals)), mask
