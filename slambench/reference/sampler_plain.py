"""Plain grouped bilinear sampler of the text residuals: each group of
samples gets one region of its image (origins snapped down to 8-row /
128-column tiles, the whole padded level along an axis where it fits); a
sample is kept when it lies in the image and in its group's region, and its
value is the bilinear mix of its four neighbours (reads past the image are
0). The contract the program's sampler kernel follows, written out in plain
PyTorch and frozen here; it imports nothing of the program.

`dtype` is the precision of the arithmetic: float64 for the reference, the
images rounded to bfloat16 (a pyramid stored at half width, the step a
later change might take) for the control.
"""

from __future__ import annotations

import torch

ALIGN_Y, ALIGN_X = 8, 128
REGION_H, REGION_W = 160, 384


def sample(imgs: torch.Tensor, group_k: torch.Tensor, uv: torch.Tensor,
           dtype=torch.float64, storage=None):
    """(vals [G, Q, 3], mask [G, Q]) for imgs [K, H, W, 3], group_k [G],
    uv [G, Q, 2]."""
    if storage is not None:
        imgs = imgs.to(storage)
    imgs = imgs.to(dtype)
    uv = torch.nan_to_num(uv.to(dtype), nan=-1e6, posinf=1e6, neginf=-1e6)
    _, H, W, _ = imgs.shape
    H8 = -(-H // ALIGN_Y) * ALIGN_Y
    W128 = -(-W // ALIGN_X) * ALIGN_X
    RH = H8 if H8 <= REGION_H else REGION_H
    RW = W128 if W128 <= REGION_W else REGION_W
    u, v = uv[..., 0], uv[..., 1]
    in_img = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)

    def origin(x, full, align, hi):
        if full:
            return torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
        lo = torch.where(in_img, x, torch.full_like(x, 1e9)).amin(1)
        lo = torch.where(lo < 1e9, lo, torch.zeros_like(lo))
        return (torch.floor(lo).long() // align * align).clamp(0, hi)

    ox = origin(u, RW == W128, ALIGN_X, W128 - RW)
    oy = origin(v, RH == H8, ALIGN_Y, H8 - RH)
    mask = in_img & (u >= ox[:, None]) & (u <= ox[:, None] + RW - 1) \
        & (v >= oy[:, None]) & (v <= oy[:, None] + RH - 1)
    ur = (u - ox[:, None]).clamp(0.0, RW - 1)
    vr = (v - oy[:, None]).clamp(0.0, RH - 1)
    u0 = torch.floor(ur).long().clamp(0, RW - 2)
    v0 = torch.floor(vr).long().clamp(0, RH - 2)
    du, dv = (ur - u0)[..., None], (vr - v0)[..., None]
    x0, y0 = ox[:, None] + u0, oy[:, None] + v0
    kk = group_k.long()[:, None]

    def read(y, x):
        val = imgs[kk, y.clamp(max=H - 1), x.clamp(max=W - 1)]
        return torch.where(((y < H) & (x < W))[..., None], val, torch.zeros_like(val))

    top = (1 - du) * read(y0, x0) + du * read(y0, x0 + 1)
    bot = (1 - du) * read(y0 + 1, x0) + du * read(y0 + 1, x0 + 1)
    vals = (1 - dv) * top + dv * bot
    return torch.where(mask[..., None], vals, torch.zeros_like(vals)), mask


def sample_error(vals: torch.Tensor, mask: torch.Tensor, ref_vals: torch.Tensor,
                 ref_mask: torch.Tensor) -> tuple:
    """(largest |vals - ref| / (1 + |ref|) over the samples both keep,
    samples whose mask differs)."""
    both = mask & ref_mask
    err = ((vals.double() - ref_vals.double()).abs() / (1 + ref_vals.double().abs()))
    err = torch.where(both[..., None], err, torch.zeros_like(err))
    return float(err.max()) if err.numel() else 0.0, int((mask != ref_mask).sum())
