"""Peaks of the card and the least work of each hand-written kernel's call.

A call's bound is the larger of its bytes over the memory rate and its
operations over the 32-bit rate outside the tensor cores: every input byte
read once, every output byte written once, and the operations the
arithmetic needs (NVIDIA H100 SXM data sheet, dense, at 700 W).
"""

from __future__ import annotations

import torch

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "ops32_per_s": 67e12,
                              "tf32_flops": 495e12, "bf16_flops": 989e12},
}


def peaks(kind: str) -> dict:
    """The peaks of a card by its name; a card not in the table raises."""
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(f"no peaks for {kind!r}; add the card's data sheet rates") from None


def bound_s(n_bytes: float, n_ops: float, kind: str) -> float:
    p = peaks(kind)
    return max(n_bytes / p["bytes_per_s"], n_ops / p["ops32_per_s"])


def hamming_work(n1: int, n2: int, alt: bool) -> tuple:
    """(bytes, operations) of an [n1, n2] distance matrix of 256-bit
    descriptors: both sets read, the int32 matrix written; per pair and
    word an AND, a population count and an add (with an alternate set:
    twice that and a minimum)."""
    n_bytes = ((2 if alt else 1) * n1 + n2) * 32 + n1 * n2 * 4
    n_ops = n1 * n2 * (8 * 6 + 1) if alt else n1 * n2 * 8 * 3
    return n_bytes, n_ops


def sampler_work(imgs_shape, group_k: torch.Tensor, uv: torch.Tensor,
                 mask: torch.Tensor) -> tuple:
    """(bytes, operations) of one grouped bilinear sampling call: uv and
    group_k read, samples [G, Q, 3] float32 and the mask written, and each
    distinct neighbour pixel of a kept sample read once (3 channels); 12
    operations per sample and channel."""
    _, H, W, C = imgs_shape
    G, Q = mask.shape
    u0 = torch.floor(uv[..., 0]).long()
    v0 = torch.floor(uv[..., 1]).long()
    k = group_k.long()[:, None].expand(G, Q)
    pix = []
    for dy in (0, 1):
        for dx in (0, 1):
            y, x = v0 + dy, u0 + dx
            ok = mask & (y < H) & (x < W)
            pix.append(((k * H + y) * W + x)[ok])
    n_pix = int(torch.unique(torch.cat(pix)).numel())
    return G * Q * (2 * 4 + 1 + C * 4) + G * 8 + n_pix * C * 4, G * Q * C * 12
