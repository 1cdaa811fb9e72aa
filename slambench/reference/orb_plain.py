"""Plain ORB of one frame: FAST-9/16 score maps over an antialiased bilinear
pyramid, 3x3 non-maximum suppression, per-cell boosted top-k, intensity
centroid angle and rotated BRIEF-256, plus the in-box pass over the text
detections. The design the program's frame build follows, written out in
plain PyTorch and frozen here; it imports nothing of the program.

`storage` rounds every image the computation keeps (the frame, each level,
each blurred level, each score map) to that dtype: float32 is the
reference, bfloat16 the lower-precision control.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

HALF_PATCH = 15
PATCH = 31
CIRCLE = np.array([(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
                   (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3)])
ARC = 9


def _brief_pattern(seed: int = 7, n_bits: int = 256) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, PATCH / 5.0, size=(n_bits, 2, 2))
    return np.clip(np.round(pts), -(HALF_PATCH - 2), HALF_PATCH - 2).astype(np.float32)


BRIEF = _brief_pattern()
_DY, _DX = np.mgrid[-HALF_PATCH:HALF_PATCH + 1, -HALF_PATCH:HALF_PATCH + 1]
DISC = (_DX ** 2 + _DY ** 2 <= HALF_PATCH ** 2).astype(np.float32)


def sep_filter(img: torch.Tensor, k) -> torch.Tensor:
    """Separable symmetric filter, reflected border (REFLECT_101), rows
    then columns, tap 0 first."""
    r = len(k) // 2
    H, W = img.shape
    pad = F.pad(img[None, None], (r, r, r, r), mode="reflect")[0, 0]
    x = 0
    for i, kv in enumerate(float(v) for v in np.asarray(k, np.float32)):
        x = x + kv * pad[:, i:i + W]
    y = 0
    for i, kv in enumerate(float(v) for v in np.asarray(k, np.float32)):
        y = y + kv * x[i:i + H, :]
    return y


def border(H: int, W: int, b: int, device) -> torch.Tensor:
    ys = torch.arange(H, device=device)[:, None]
    xs = torch.arange(W, device=device)[None, :]
    return (ys >= b) & (ys < H - b) & (xs >= b) & (xs < W - b)


def fast_scores(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9 score (the largest threshold at which the pixel stays a
    corner), 0 below `threshold` and on a 3 px border, then 3x3 NMS."""
    H, W = img.shape
    ring = torch.stack([torch.roll(img, shifts=(-int(dy), -int(dx)), dims=(0, 1))
                        for dx, dy in CIRCLE])

    def arc(d):
        m = torch.cat([d, d[:ARC - 1]], 0)
        m = torch.minimum(m[:-1], m[1:])
        m = torch.minimum(m[:-2], m[2:])
        m = torch.minimum(m[:-4], m[4:])
        m = torch.minimum(m[:-1], m[1:])
        return m[:16].amax(0)

    s = torch.maximum(arc(ring - img[None]), arc(img[None] - ring))
    s = torch.where((s > threshold) & border(H, W, 3, img.device), s, torch.zeros_like(s))
    p = F.pad(s, (1, 1, 1, 1), value=float("-inf"))
    neigh = torch.stack([p[dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)
                         if not (dy == 1 and dx == 1)]).amax(0)
    return torch.where(s >= neigh, s, torch.zeros_like(s))


def select(score: torch.Tensor, n_keep: int, cell: int):
    """Per-cell winners first, then the strongest others; ties keep the
    lower pixel index. Returns (uv [n, 2], valid [n])."""
    H, W = score.shape
    Hp, Wp = -(-H // cell) * cell, -(-W // cell) * cell
    sp = F.pad(score, (0, Wp - W, 0, Hp - H))
    cmax = sp.reshape(Hp // cell, cell, Wp // cell, cell).amax(dim=(1, 3))
    cmax = cmax.repeat_interleave(cell, 0).repeat_interleave(cell, 1)[:H, :W]
    boosted = torch.where((score > 0) & (score >= cmax), score + 1e6, score)
    vals, idx = torch.sort(boosted.reshape(-1), descending=True, stable=True)
    vals, idx = vals[:n_keep], idx[:n_keep]
    v = idx // W
    return torch.stack([(idx - v * W).float(), v.float()], -1), vals > 0


def angle(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    H, W = img.shape
    dev = img.device
    u0 = torch.round(uv[:, 0]).long().clamp(HALF_PATCH, W - 1 - HALF_PATCH) - HALF_PATCH
    v0 = torch.round(uv[:, 1]).long().clamp(HALF_PATCH, H - 1 - HALF_PATCH) - HALF_PATCH
    off = torch.arange(PATCH, device=dev)
    patch = img[(v0[:, None] + off)[:, :, None], (u0[:, None] + off)[:, None, :]]
    disc = torch.as_tensor(DISC, device=dev)
    m10 = (patch * disc * torch.as_tensor(_DX, dtype=torch.float32, device=dev)).sum((1, 2))
    m01 = (patch * disc * torch.as_tensor(_DY, dtype=torch.float32, device=dev)).sum((1, 2))
    return torch.atan2(m01, m10)


def brief(blurred: torch.Tensor, uv: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotated BRIEF-256 as [N, 8] int32 words (bit i of word j = pair 32 j + i)."""
    pat = torch.as_tensor(BRIEF, device=blurred.device)
    c, s = torch.cos(ang)[:, None, None], torch.sin(ang)[:, None, None]
    px, py = pat[None, ..., 0], pat[None, ..., 1]
    pos = uv[:, None, None, :] + torch.stack([c * px - s * py, s * px + c * py], -1)
    H, W = blurred.shape
    ui = torch.round(pos[..., 0]).long().clamp(0, W - 1)
    vi = torch.round(pos[..., 1]).long().clamp(0, H - 1)
    smp = blurred[vi, ui]
    bits = (smp[..., 0] < smp[..., 1]).long().reshape(-1, 8, 32)
    w = (bits << torch.arange(32, device=blurred.device)).sum(-1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def _gauss7() -> np.ndarray:
    x = np.arange(-3, 4, dtype=np.float32)
    k = np.exp(-(x ** 2) / (2 * 2.0 ** 2))
    return k / k.sum()


def level_budget(n_features: int, n_levels: int, scale: float) -> list:
    inv = 1.0 / scale
    base = n_features / ((1 - inv ** n_levels) / (1 - inv))
    ns = [int(round(base * inv ** l)) for l in range(n_levels)]
    ns[-1] = max(ns[-1], n_features - sum(ns[:-1]))
    return ns


def quad_mask(quad: torch.Tensor, H: int, W: int) -> torch.Tensor:
    u = torch.arange(W, dtype=torch.float32, device=quad.device)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=quad.device)[:, None]
    e = torch.roll(quad, -1, dims=-2) - quad
    cross = (e[..., :, None, None, 0] * (v - quad[..., :, None, None, 1])
             - e[..., :, None, None, 1] * (u - quad[..., :, None, None, 0]))
    return (cross >= 0).all(-3) | (cross <= 0).all(-3)


def orb(img: torch.Tensor, n_features: int, n_levels: int, scale: float, threshold: float,
        quads=None, n_box: int = 256, shrink: float = 3.0, storage=torch.float32) -> dict:
    """Keypoints of one frame: {uv [N, 2] level-0 px, level [N], desc [N, 8]
    int32, valid [N]} for the pyramid pass, then the in-box pass over
    `quads` [D, 4, 2] when given."""
    def keep(t):
        return t.to(storage).float()

    img = keep(img.float())
    H0, W0 = img.shape
    uvs, lvls, descs, valids = [], [], [], []
    for l, n_l in enumerate(level_budget(n_features, n_levels, scale)):
        if l == 0:
            im = img
        else:
            size = (int(round(H0 / scale ** l)), int(round(W0 / scale ** l)))
            im = keep(F.interpolate(img[None, None], size=size, mode="bilinear",
                                    antialias=True, align_corners=False)[0, 0])
        if min(im.shape) < PATCH + 8 or n_l <= 0:
            continue
        sm = keep(fast_scores(im, threshold))
        sm = torch.where(border(*im.shape, HALF_PATCH + 2, im.device), sm, torch.zeros_like(sm))
        uv, val = select(sm, n_l, 16)
        d = brief(keep(sep_filter(im, _gauss7())), uv, angle(im, uv))
        uvs.append(uv * scale ** l)
        lvls.append(torch.full((n_l,), l, dtype=torch.int32, device=im.device))
        descs.append(d)
        valids.append(val)
    if quads is not None and len(quads):
        H, W = img.shape
        sm = keep(fast_scores(img, threshold))
        q = torch.as_tensor(np.asarray(quads, np.float32), device=img.device)
        c = q.mean(1, keepdim=True)
        dq = c - q
        dq = dq / torch.linalg.norm(dq, dim=-1, keepdim=True).clamp(min=1e-6)
        inbox = quad_mask(q + shrink * dq, H, W).any(0)
        sm = torch.where(inbox & border(H, W, HALF_PATCH + 2, img.device), sm,
                         torch.zeros_like(sm))
        uv, val = select(sm, n_box, 8)
        descs.append(brief(keep(sep_filter(img, _gauss7())), uv, angle(img, uv)))
        uvs.append(uv)
        lvls.append(torch.zeros((n_box,), dtype=torch.int32, device=img.device))
        valids.append(val)
    return {"uv": torch.cat(uvs), "level": torch.cat(lvls), "desc": torch.cat(descs),
            "valid": torch.cat(valids)}


def keypoint_mismatch(prog: dict, ref: dict) -> tuple:
    """(mismatched, compared): the valid keypoints of either side that the
    other lacks, and the valid keypoints of both sides; a keypoint is its
    level-0 position, level and descriptor, each exact."""
    def rows(kp):
        v = kp["valid"].cpu().numpy().astype(bool)
        uv = kp["uv"].cpu().numpy()[v].astype(np.float32)
        lv = kp["level"].cpu().numpy()[v].astype(np.int32)
        d = kp["desc"].cpu().numpy()[v].astype(np.int32)
        return {(a.tobytes(), int(b), c.tobytes()) for a, b, c in zip(uv, lv, d)}

    p, r = rows(prog), rows(ref)
    return len(p ^ r), len(p) + len(r)
