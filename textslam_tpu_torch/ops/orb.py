"""Batched ORB feature extraction, port of textslam_tpu/ops/orb.py.

Same design as the JAX version: dense FAST score maps per level at the low
threshold, per-cell winner boosting + one global top-k for spatial
uniformity, then intensity-centroid orientation and rotated BRIEF-256 as
batched patch gathers. The BRIEF pattern comes from the same seeded numpy
recipe, so descriptors are bit-compatible with the JAX package.

Descriptors are carried as int32 [N, 8] holding the bits of the JAX
package's uint32 words (numpy `.view(np.int32)`): torch's uint32 support is
thin, and XOR / popcount / equality only need the bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import fast
from .pyramid import _sep_conv2d_same

HALF_PATCH = 15
PATCH = 31


class Keypoints(NamedTuple):
    """Padded SoA keypoint set (level-0 pixel coordinates)."""

    uv: torch.Tensor  # [N, 2] float32, level-0 coords
    uv_level: torch.Tensor  # [N, 2] float32, coords at native level
    level: torch.Tensor  # [N] int32
    angle: torch.Tensor  # [N] float32 radians
    score: torch.Tensor  # [N] float32
    desc: torch.Tensor  # [N, 8] int32 (bits of the 256-bit BRIEF)
    valid: torch.Tensor  # [N] bool


def _make_brief_pattern(seed: int = 7, n_bits: int = 256) -> np.ndarray:
    """Deterministic BRIEF-256 sampling pairs within the 31x31 patch:
    i.i.d. isotropic Gaussian pairs (sigma = patch/5), clipped to the patch.
    The same recipe and seed as the JAX package."""
    rng = np.random.default_rng(seed)
    sigma = PATCH / 5.0
    pts = rng.normal(0.0, sigma, size=(n_bits, 2, 2))
    pts = np.clip(np.round(pts), -(HALF_PATCH - 2), HALF_PATCH - 2)
    return pts.astype(np.float32)  # [256, 2(pair), 2(xy)]


BRIEF_PATTERN = _make_brief_pattern()

# circular-patch mask for IC_Angle (radius-15 disc)
_DY, _DX = np.mgrid[-HALF_PATCH : HALF_PATCH + 1, -HALF_PATCH : HALF_PATCH + 1]
CIRC_MASK = (_DX**2 + _DY**2 <= HALF_PATCH**2).astype(np.float32)  # [31,31]


def gauss_blur7(img: torch.Tensor) -> torch.Tensor:
    """7x7 Gaussian (sigma=2) applied before descriptor sampling."""
    x = np.arange(-3, 4, dtype=np.float32)
    k = np.exp(-(x**2) / (2 * 2.0**2))
    k /= k.sum()
    return _sep_conv2d_same(img, k)


def select_keypoints(score: torch.Tensor, n_keep: int, cell: int = 16):
    """Spatially-uniform top-k selection from a dense score map.

    Per-cell winners are boosted above all other scores, then one global
    top-k picks boosted winners first and back-fills with the strongest
    remaining corners. XLA's top_k keeps the lower index first among equal
    values; a stable descending sort reproduces that (torch.topk promises no
    tie order).

    Returns (uv [n_keep, 2] float32, scores [n_keep], valid [n_keep]).
    """
    H, W = score.shape
    Hp = (H + cell - 1) // cell * cell
    Wp = (W + cell - 1) // cell * cell
    sp = F.pad(score, (0, Wp - W, 0, Hp - H))
    cells = sp.reshape(Hp // cell, cell, Wp // cell, cell).permute(0, 2, 1, 3)
    cell_max = cells.amax(dim=(2, 3))  # [hc, wc]
    cell_max_b = cell_max.repeat_interleave(cell, 0).repeat_interleave(cell, 1)[:H, :W]
    is_winner = (score > 0) & (score >= cell_max_b)
    BIG = 1e6
    boosted = torch.where(is_winner, score + BIG, score)
    vals, idx = torch.sort(boosted.reshape(-1), descending=True, stable=True)
    vals, idx = vals[:n_keep], idx[:n_keep]
    vrow = idx // W
    ucol = idx - vrow * W
    uv = torch.stack([ucol.float(), vrow.float()], dim=-1)
    raw = torch.where(vals > BIG / 2, vals - BIG, vals)
    valid = vals > 0
    return uv, raw, valid


def _gather_patches(img: torch.Tensor, uv: torch.Tensor, half: int = HALF_PATCH):
    """Gather [N, 2h+1, 2h+1] patches centered at integer uv. Patches that
    would leave the image are clamped (callers mask by border)."""
    H, W = img.shape
    u0 = torch.round(uv[:, 0]).long().clamp(half, W - 1 - half) - half
    v0 = torch.round(uv[:, 1]).long().clamp(half, H - 1 - half) - half
    off = torch.arange(2 * half + 1, device=img.device)
    rows = (v0[:, None] + off)[:, :, None]
    cols = (u0[:, None] + off)[:, None, :]
    return img[rows, cols]


def ic_angle(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation over the radius-15 disc (IC_Angle)."""
    patches = _gather_patches(img, uv)  # [N, 31, 31]
    dev = img.device
    mask = torch.as_tensor(CIRC_MASK, device=dev)
    dx = torch.as_tensor(_DX, dtype=torch.float32, device=dev)
    dy = torch.as_tensor(_DY, dtype=torch.float32, device=dev)
    m10 = (patches * mask * dx).sum(dim=(1, 2))
    m01 = (patches * mask * dy).sum(dim=(1, 2))
    return torch.atan2(m01, m10)


def brief_descriptors(blurred: torch.Tensor, uv: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotated BRIEF-256 (rBRIEF): rotate the pair pattern by the keypoint
    angle, nearest-sample the blurred image, compare, pack to int32[8]."""
    pat = torch.as_tensor(BRIEF_PATTERN, device=blurred.device)  # [256, 2, 2]
    ca = torch.cos(angle)[:, None, None]
    sa = torch.sin(angle)[:, None, None]
    px, py = pat[None, ..., 0], pat[None, ..., 1]
    rot = torch.stack([ca * px - sa * py, sa * px + ca * py], dim=-1)  # [N,256,2,2]
    pos = uv[:, None, None, :] + rot
    H, W = blurred.shape
    ui = torch.round(pos[..., 0]).long().clamp(0, W - 1)
    vi = torch.round(pos[..., 1]).long().clamp(0, H - 1)
    samples = blurred[vi, ui]  # [N, 256, 2]
    bits = (samples[..., 0] < samples[..., 1]).long()  # [N,256]
    words = bits.reshape(bits.shape[0], 8, 32)
    shifts = torch.arange(32, device=blurred.device)
    w = (words << shifts).sum(dim=-1)  # [N, 8] in [0, 2^32)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def _level_allocation(n_features: int, n_levels: int, scale: float) -> list:
    """Per-level keypoint budget, geometric in 1/scale."""
    inv = 1.0 / scale
    total = (1 - inv**n_levels) / (1 - inv)
    base = n_features / total
    ns = [int(round(base * inv**l)) for l in range(n_levels)]
    ns[-1] = max(ns[-1], n_features - sum(ns[:-1]))
    return ns


def extract_orb(
    img: torch.Tensor,
    n_features: int = 1000,
    n_levels: int = 8,
    scale: float = 1.2,
    threshold: float = 7.0,
    cell: int = 16,
) -> Keypoints:
    """Full ORB extraction for one grayscale image [H, W] float32.

    Returns a padded Keypoints pool of size n_total (sum of per-level
    budgets), level-0 coordinates, validity-masked. Levels come from an
    antialiased bilinear resize of level 0, which is what
    jax.image.resize(..., "bilinear") computes.
    """
    alloc = _level_allocation(n_features, n_levels, scale)
    img = img.float()
    H0, W0 = img.shape
    levels = [img]
    for l in range(1, n_levels):
        h = int(round(H0 / scale**l))
        w = int(round(W0 / scale**l))
        levels.append(F.interpolate(img[None, None], size=(h, w), mode="bilinear",
                                    antialias=True, align_corners=False)[0, 0])

    outs = []
    for l, (im, n_l) in enumerate(zip(levels, alloc)):
        if min(im.shape) < PATCH + 8 or n_l <= 0:
            continue
        smap = fast.nms3(fast.fast_score_map(im, threshold))
        # keep the descriptor patch inside the image: zero a 17px border
        H, W = im.shape
        inb = fast._border_mask(H, W, HALF_PATCH + 2, im.device)
        smap = torch.where(inb, smap, torch.zeros_like(smap))
        uv_l, sc, val = select_keypoints(smap, n_l, cell=cell)
        ang = ic_angle(im, uv_l)
        desc = brief_descriptors(gauss_blur7(im), uv_l, ang)
        outs.append((
            uv_l * (scale**l), uv_l,
            torch.full((n_l,), l, dtype=torch.int32, device=im.device),
            ang, sc, desc, val,
        ))
    return Keypoints(*(torch.cat([o[i] for o in outs]) for i in range(7)))


def extract_box_orb(
    img: torch.Tensor,
    quads: torch.Tensor,
    quads_valid: torch.Tensor,
    n_keep: int = 256,
    cell: int = 8,
    threshold: float = 7.0,
    shrink: float = 3.0,
) -> Keypoints:
    """Text-box feature densification + boundary pruning in one pass: the
    level-0 FAST score map is zeroed outside the union of the detection
    quads [D, 4, 2] (validity [D]) with their corners pulled `shrink` px
    toward the centroid, then the per-cell-boosted top-k keeps up to n_keep
    in-box corners, with IC angle + rBRIEF as in the main pass. Returns a
    level-0 Keypoints pool of size n_keep."""
    from . import rasterize

    H, W = img.shape
    img = img.float()
    smap = fast.nms3(fast.fast_score_map(img, threshold))
    inb = fast._border_mask(H, W, HALF_PATCH + 2, img.device)
    c = quads.mean(dim=1, keepdim=True)  # [D, 1, 2]
    d = c - quads
    dn = d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp(min=1e-6)
    masks = rasterize.quad_mask(quads + shrink * dn, H, W)  # [D, H, W]
    inbox = (masks & quads_valid[:, None, None]).any(dim=0)
    smap = torch.where(inbox & inb, smap, torch.zeros_like(smap))
    uv, sc, val = select_keypoints(smap, n_keep, cell=cell)
    ang = ic_angle(img, uv)
    desc = brief_descriptors(gauss_blur7(img), uv, ang)
    return Keypoints(uv=uv, uv_level=uv,
                     level=torch.zeros((n_keep,), dtype=torch.int32, device=img.device),
                     angle=ang, score=sc, desc=desc, valid=val)


def pack_keypoints(*kps: Keypoints) -> torch.Tensor:
    """Pack Keypoints pools into one [N, 14] float32 tensor for ONE
    device->host transfer (cols: uv 2, level 1, angle 1, score 1, valid 1,
    desc bits 8). The descriptor columns hold int32 bits reinterpreted as
    float32: they are assembled in the int32 domain and reinterpreted with
    Tensor.view, never passed through float arithmetic or a cast. Decode
    with unpack_keypoints_np."""
    rows = []
    for kp in kps:
        f = torch.cat([
            kp.uv,
            kp.level.float()[:, None],
            kp.angle[:, None],
            kp.score[:, None],
            kp.valid.float()[:, None],
        ], dim=1)
        rows.append(torch.cat([f.view(torch.int32), kp.desc], dim=1))
    return torch.cat(rows, dim=0).view(torch.float32)


def packed_desc(packed: torch.Tensor) -> torch.Tensor:
    """Descriptor bits [N, 8] int32 (contiguous) of a packed keypoint pool."""
    return packed[:, 6:14].view(torch.int32).contiguous()


def unpack_keypoints_np(packed: np.ndarray):
    """Host-side decode of pack_keypoints output.

    Returns (uv [N,2] f32, level [N] i32, angle [N] f32, score [N] f32,
    valid [N] bool, desc [N,8] u32) — descriptors as uint32, the JAX
    package's host layout."""
    uv = packed[:, 0:2].astype(np.float32)
    level = packed[:, 2].astype(np.int32)
    angle = packed[:, 3].astype(np.float32)
    score = packed[:, 4].astype(np.float32)
    valid = packed[:, 5] > 0.5
    desc = np.ascontiguousarray(packed[:, 6:14], dtype=np.float32).view(np.uint32)
    return uv, level, angle, score, valid, desc
