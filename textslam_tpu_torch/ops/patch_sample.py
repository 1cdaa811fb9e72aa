"""Grouped region sampler of the text residuals, port of the Pallas kernel
textslam_tpu/ops/pallas_kernels.py::patch_sample_grouped and its wrapper
grouped_bilinear_stack.

Text observations arrive grouped, one group per (text object, target
keyframe) pair, and all of a group's samples lie inside one projected text
box. Each group gets one region origin; a sample is kept when it lies in
the image AND in its group's region. The region arithmetic is the TPU
wrapper's, kept exactly because it decides which samples are masked:
origins snap down to 8-row / 128-px tiles, and a level whose padded extent
(H8, W128) fits the region uses the whole image (origin 0).

For a CUDA stack `grouped_bilinear_stack` is one launch of the hand-written
kernel (csrc/patch_sample.cu), which computes the origins, the mask and the
samples; its scalar arguments come from `launch_args`, pure Python on shapes
and strides. A CPU stack takes `grouped_bilinear_stack_plain`'s arithmetic
(`regions`, then `_plain_values`). There is no fallback from the kernel to
the plain version. Sampling is float32: the TPU's single-pass bf16 mode has
no counterpart here.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import torch

from . import cuda_lib

ALIGN_Y = 8
ALIGN_X = 128
_BIG = 1e9


def region_shape(H: int, W: int, region_h: int, region_w: int):
    """(RH, RW, H8, W128): the group region, or the whole padded level
    (H8, W128) along an axis where it fits."""
    H8 = -(-H // ALIGN_Y) * ALIGN_Y
    W128 = -(-W // ALIGN_X) * ALIGN_X
    RH = H8 if H8 <= region_h else region_h
    RW = W128 if W128 <= region_w else region_w
    return RH, RW, H8, W128


class LaunchArgs(NamedTuple):
    """The kernel's scalar arguments, in the order of csrc/patch_sample.cu's
    LaunchArgs struct (packed by PACK)."""
    img_stride: int
    row_stride: int
    k_stride: int  # group_k's element stride: a strided view is read in place
    G: int
    Q: int
    H: int
    W: int
    RH: int
    RW: int
    H8: int
    W128: int
    full_h: int  # the padded level height fits the region: origin row 0
    full_w: int  # ... and the width: origin column 0


PACK = struct.Struct("=3q10i")  # LaunchArgs as the C struct: 3 int64, 10 int32


def launch_args(imgs: torch.Tensor, group_k: torch.Tensor, uv: torch.Tensor,
                region_h: int = 160, region_w: int = 384) -> LaunchArgs:
    """Check the inputs (raising on what the kernel does not take) and
    return the kernel's scalar arguments: pure Python on types, shapes and
    strides, no tensor op and no device access, so it is cheap per call."""
    for name, t in (("imgs", imgs), ("group_k", group_k), ("uv", uv)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if imgs.dtype != torch.float32 or uv.dtype != torch.float32:
        raise TypeError(f"imgs and uv must be float32, got {imgs.dtype} and {uv.dtype}")
    if group_k.dtype != torch.int64:
        raise TypeError(f"group_k must be int64, got {group_k.dtype}")
    if imgs.dim() != 4 or uv.dim() != 3 or uv.shape[2] != 2 or group_k.dim() != 1:
        raise ValueError(f"want imgs [K, H, W, 3], group_k [G], uv [G, Q, 2]; got "
                         f"{tuple(imgs.shape)}, {tuple(group_k.shape)}, {tuple(uv.shape)}")
    G, Q, _ = uv.shape
    if group_k.shape[0] != G:
        raise ValueError(f"group_k has {group_k.shape[0]} groups, uv {G}")
    _, H, W, C = imgs.shape
    if H < 2 or W < 2 or C != 3:
        raise ValueError(f"imgs [K, H, W, 3] needs H, W >= 2, got {tuple(imgs.shape)}")
    # the kernel reads a pixel's channels and a row's pixels contiguously;
    # image and row strides are free, so a packed pyramid level is read in place
    img_stride, row_stride, px_stride, c_stride = imgs.stride()
    if c_stride != 1 or px_stride != 3:
        raise ValueError(f"imgs rows must be contiguous [W, 3], got strides {imgs.stride()}")
    if not uv.is_contiguous():
        raise ValueError("uv must be contiguous")
    if not (imgs.device == group_k.device == uv.device):
        raise ValueError(f"imgs on {imgs.device}, group_k on {group_k.device}, uv on {uv.device}")
    RH, RW, H8, W128 = region_shape(H, W, region_h, region_w)
    return LaunchArgs(img_stride, row_stride, group_k.stride(0), G, Q, H, W, RH, RW, H8, W128,
                      int(RH == H8), int(RW == W128))


def regions(imgs: torch.Tensor, group_k: torch.Tensor, uv: torch.Tensor,
            region_h: int, region_w: int):
    """The TPU wrapper's region arithmetic: (uv with non-finite values
    replaced, meta [G, 3] int32 rows (k, oy, ox), mask [G, Q], RH, RW)."""
    _, H, W, _ = imgs.shape
    RH, RW, H8, W128 = region_shape(H, W, region_h, region_w)
    uv = torch.nan_to_num(uv, nan=-1e6, posinf=1e6, neginf=-1e6)
    u, v = uv[..., 0], uv[..., 1]
    in_img = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)

    def origin(x, full: bool, align: int, hi: int):
        if full:
            return torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
        lo = torch.where(in_img, x, torch.full_like(x, _BIG)).amin(dim=1)
        lo = torch.where(lo < _BIG, lo, torch.zeros_like(lo))
        return (torch.floor(lo).long() // align * align).clamp(0, hi)

    ox = origin(u, RW == W128, ALIGN_X, W128 - RW)
    oy = origin(v, RH == H8, ALIGN_Y, H8 - RH)
    in_region = ((u >= ox[:, None]) & (u <= ox[:, None] + (RW - 1))
                 & (v >= oy[:, None]) & (v <= oy[:, None] + (RH - 1)))
    meta = torch.stack([group_k, oy, ox], dim=-1).to(torch.int32)
    return uv, meta, in_img & in_region, RH, RW


def _plain_values(imgs, meta, uv, mask, RH: int, RW: int) -> torch.Tensor:
    """The kernel's clamp-and-lerp with advanced indexing: [G, Q, 3]."""
    K, H, W, _ = imgs.shape
    k, oy, ox = meta.long().unbind(-1)
    u = (uv[..., 0] - ox[:, None]).clamp(0.0, RW - 1)
    v = (uv[..., 1] - oy[:, None]).clamp(0.0, RH - 1)
    u0 = torch.floor(u).long().clamp(0, RW - 2)
    v0 = torch.floor(v).long().clamp(0, RH - 2)
    du = (u - u0)[..., None]
    dv = (v - v0)[..., None]
    x0 = ox[:, None] + u0
    y0 = oy[:, None] + v0
    kk = k[:, None]

    def read(y, x):  # reads past the image are 0 (the TPU's zero padding)
        val = imgs[kk, y.clamp(max=H - 1), x.clamp(max=W - 1)]
        return torch.where(((y < H) & (x < W))[..., None], val, torch.zeros_like(val))

    top = (1.0 - du) * read(y0, x0) + du * read(y0, x0 + 1)
    bot = (1.0 - du) * read(y0 + 1, x0) + du * read(y0 + 1, x0 + 1)
    vals = (1.0 - dv) * top + dv * bot
    return torch.where(mask[..., None], vals, torch.zeros_like(vals))


def grouped_bilinear_stack_plain(imgs: torch.Tensor, group_k: torch.Tensor, uv: torch.Tensor,
                                 region_h: int = 160, region_w: int = 384):
    """Plain PyTorch version of the kernel, on any device: (vals [G, Q, 3],
    mask [G, Q])."""
    launch_args(imgs, group_k, uv, region_h, region_w)  # the kernel's checks
    uv, meta, mask, RH, RW = regions(imgs, group_k, uv, region_h, region_w)
    return _plain_values(imgs, meta, uv, mask, RH, RW), mask


def grouped_bilinear_stack(imgs: torch.Tensor, group_k: torch.Tensor, uv: torch.Tensor,
                           region_h: int = 160, region_w: int = 384):
    """Bilinear samples of grouped clusters of points.

    imgs [K, H, W, 3] float32 (I, sobel-x, sobel-y; rows contiguous);
    group_k [G] int64 image index per group (any stride); uv [G, Q, 2]
    level-pixel sample positions. Samples outside the image or outside
    their group's region return 0 with mask False. Returns (vals [G, Q, 3],
    mask [G, Q]).

    A CUDA stack is one launch of csrc/patch_sample.cu on the current
    stream, besides the two output allocations (counted in
    `grouped_bilinear_stack.launches`); a CPU stack takes the plain version.
    Anything else raises, as does a missing nvcc, a failed build or a
    refused launch."""
    a = launch_args(imgs, group_k, uv, region_h, region_w)
    if not imgs.is_cuda:
        if imgs.device.type != "cpu":
            raise RuntimeError(f"grouped_bilinear_stack has no kernel for device {imgs.device}")
        uv, meta, mask, RH, RW = regions(imgs, group_k, uv, region_h, region_w)
        return _plain_values(imgs, meta, uv, mask, RH, RW), mask
    vals = uv.new_empty((a.G, a.Q, 3))
    mask = uv.new_empty((a.G, a.Q), dtype=torch.bool)
    _launch(imgs, group_k, uv, vals, mask, a)
    grouped_bilinear_stack.launches += 1
    return vals, mask


grouped_bilinear_stack.launches = 0


def _launch(imgs, group_k, uv, vals, mask, a: LaunchArgs) -> None:
    """The kernel on (vals, mask), allocated by the caller."""
    cuda_lib.launch("patch_sample", "patch_sample_launch", imgs.device,
                    imgs.data_ptr(), group_k.data_ptr(), uv.data_ptr(), vals.data_ptr(),
                    mask.data_ptr(), PACK.pack(*a))
