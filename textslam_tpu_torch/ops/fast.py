"""Dense FAST-9/16 corner scores as batched tensor ops, port of
textslam_tpu/ops/fast.py.

Score = the classical "maximal threshold for which the pixel stays a
corner": max over the 16 contiguous 9-arcs of the min absolute center
difference within the arc, bright and dark arcs separately. 3x3 NMS follows;
per-cell selection lives in ops.orb.select_keypoints.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, OpenCV ordering (start top, clockwise)
CIRCLE = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)

ARC = 9  # FAST-9/16


def _shifted(img: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """img sampled at (x+dx, y+dy), wrapping at the borders (the 3px border
    is zeroed afterwards)."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))


def _border_mask(H: int, W: int, b: int, device) -> torch.Tensor:
    ys = torch.arange(H, device=device)[:, None]
    xs = torch.arange(W, device=device)[None, :]
    return (ys >= b) & (ys < H - b) & (xs >= b) & (xs < W - b)


def fast_score_map(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Per-pixel FAST-9 corner score [H, W]; 0 where not a corner at
    `threshold`. Border of 3px is zeroed."""
    H, W = img.shape
    ring = torch.stack([_shifted(img, int(dx), int(dy)) for dx, dy in CIRCLE])  # [16,H,W]
    dpos = ring - img[None]  # brighter by d
    dneg = img[None] - ring  # darker by d

    def arc_score(d):
        # min over each 9-arc (log-step pairwise mins), then max over starts
        m = torch.cat([d, d[: ARC - 1]], dim=0)  # wraparound [24,H,W]
        m = torch.minimum(m[:-1], m[1:])  # width 2
        m = torch.minimum(m[:-2], m[2:])  # width 4
        m = torch.minimum(m[:-4], m[4:])  # width 8
        m = torch.minimum(m[:-1], m[1:])  # width 9
        return m[:16].amax(dim=0)  # [H,W]

    score = torch.maximum(arc_score(dpos), arc_score(dneg))
    score = torch.where(score > threshold, score, torch.zeros_like(score))
    return torch.where(_border_mask(H, W, 3, img.device), score, torch.zeros_like(score))


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression: keep score only at local maxima."""
    H, W = score.shape
    p = F.pad(score, (1, 1, 1, 1), value=float("-inf"))
    neigh = torch.stack(
        [
            p[dy : dy + H, dx : dx + W]
            for dy in range(3)
            for dx in range(3)
            if not (dy == 1 and dx == 1)
        ]
    )
    is_max = score >= neigh.amax(dim=0)
    return torch.where(is_max, score, torch.zeros_like(score))
