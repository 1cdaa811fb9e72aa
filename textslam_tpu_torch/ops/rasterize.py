"""Quad rasterization, port of textslam_tpu/ops/rasterize.py: point-in-quad
masks, masked box statistics and label lookup for text/detection
association. A quad mask is four dense half-plane tests, no polygon fill.
"""

from __future__ import annotations

import torch


def quad_mask(quad: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Dense [..., H, W] bool mask of pixels inside (convex) quads [..., 4, 2]:
    a point is inside iff all four edge cross-products share a sign."""
    dev = quad.device
    u = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    e = torch.roll(quad, -1, dims=-2) - quad  # edge vectors [..., 4, 2]
    rel_u = u - quad[..., :, None, None, 0]  # [..., 4, H, W]
    rel_v = v - quad[..., :, None, None, 1]
    cross = e[..., :, None, None, 0] * rel_v - e[..., :, None, None, 1] * rel_u
    return (cross >= 0).all(dim=-3) | (cross <= 0).all(dim=-3)


def point_in_quad(points: torch.Tensor, quad: torch.Tensor) -> torch.Tensor:
    """points [..., 2] vs quad [4, 2] (or broadcastable) -> bool [...]."""
    e = torch.roll(quad, -1, dims=-2) - quad
    rel = points[..., None, :] - quad  # [..., 4, 2]
    cross = e[..., 0] * rel[..., 1] - e[..., 1] * rel[..., 0]
    return (cross >= 0).all(dim=-1) | (cross <= 0).all(dim=-1)


def quad_stats(img: torch.Tensor, quad: torch.Tensor, valid_shape=None):
    """(mu, sigma, n) of image intensities inside each quad.

    img [..., H, W] and quad [..., 4, 2] broadcast over their leading dims
    (the batch axis that jax.vmap gives the JAX version). sigma floors at
    1e-3. valid_shape (h, w) restricts the mask to the true extent of a
    padded pyramid level."""
    H, W = img.shape[-2:]
    mask = quad_mask(quad, H, W)
    if valid_shape is not None:
        dev = img.device
        inb = ((torch.arange(W, device=dev)[None, :] < valid_shape[1])
               & (torch.arange(H, device=dev)[:, None] < valid_shape[0]))
        mask = mask & inb
    n = mask.sum(dim=(-2, -1))
    nf = n.clamp(min=1).to(img.dtype)
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    mu = torch.where(mask, img, zero).sum(dim=(-2, -1)) / nf
    var = torch.where(mask, (img - mu[..., None, None]) ** 2, zero).sum(dim=(-2, -1)) / nf
    return mu, torch.sqrt(var).clamp(min=1e-3), n


def label_lookup(quads: torch.Tensor, quads_valid: torch.Tensor, points: torch.Tensor):
    """For each point [D, 2], the index of the lowest valid quad [T, 4, 2]
    containing it, or -1 -> [D] int32."""
    inside = point_in_quad(points[None, :, :], quads[:, None, :, :])  # [T, D]
    inside = inside & quads_valid[:, None]
    T = quads.shape[0]
    idx = torch.where(inside, torch.arange(T, device=quads.device)[:, None], T)
    best = idx.amin(dim=0)
    return torch.where(best < T, best, -1).to(torch.int32)
