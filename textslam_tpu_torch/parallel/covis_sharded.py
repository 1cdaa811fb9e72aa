"""Keyframe-axis-sharded covisibility products, port of
textslam_tpu/parallel/covis_sharded.py.

The map rebuilds its covisibility matrices as incidence products
M = inc @ inc.T (mapper/state.py). Here the keyframe axis of the incidence
is cut into row blocks, one per shard of the mesh; each shard contracts its
block against the whole incidence in a float32 matmul, and the blocks are
gathered on the home device.

The counts are exact in float32 while every sum stays below 2^24 and the
matmul runs in full float32: TF32 (10 mantissa bits) would round them, so
the product refuses to run with it on. The incidence goes to the device as
uint8 (a quarter of float32's bytes) and widens there.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh

EXACT_MAX = 2 ** 24  # float32 represents every integer up to here


def covis_product(inc: np.ndarray, mesh: Mesh, w: np.ndarray | None = None) -> np.ndarray:
    """Sharded M = inc @ inc.T (or (inc * w) @ inc.T), zero diagonal.

    inc [K, n] bool observation incidence; w [n] optional non-negative
    integer weights. Returns int32 [K, K], bit-identical to the host
    product."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("covis_product needs full float32 matmuls; TF32 is on "
                           "(torch.backends.cuda.matmul.allow_tf32)")
    K, n = inc.shape
    wmax = 1 if w is None else int(np.max(w, initial=0))
    if n * wmax >= EXACT_MAX:
        raise ValueError(f"covis_product: sums up to {n} x {wmax} are not exact in float32")
    n_shards = mesh.size
    Kb = (K + n_shards - 1) // n_shards
    inc_u8 = np.zeros((Kb * n_shards, n), np.uint8)
    inc_u8[:K] = inc
    host = torch.from_numpy(inc_u8)
    w_host = None if w is None else torch.from_numpy(np.asarray(w, np.float32))
    parts = []
    widened = {}  # one upload per distinct device
    for s, d in mesh.local_shards():
        if d not in widened:
            widened[d] = host.to(d).float()
        full = widened[d]
        rows = full[s * Kb:(s + 1) * Kb]
        if w_host is not None:
            rows = rows * w_host.to(d)[None, :]
        out = torch.zeros((Kb * n_shards, Kb * n_shards), device=d)
        out[s * Kb:(s + 1) * Kb] = rows @ full.T
        parts.append([out])
    (M,) = mesh.all_sum(parts)
    M = M[:K, :K].cpu().numpy().astype(np.int32)
    np.fill_diagonal(M, 0)
    return M
