"""Batched Levenshtein distance for semantic loop detection, port of
textslam_tpu/ops/levenshtein.py.

The DP runs as a row wavefront over padded codepoint arrays, batched over
all (query, map word) pairs at once: each row of the DP updates the whole
[Q, T, L+1] frontier, and the left-neighbour dependency within a row is a
prefix minimum (torch.cummin on the last axis, where the JAX version takes
lax.associative_scan(jnp.minimum)). Strings longer than the device tier cap
go through the native host routine `native.levenshtein_batch` (threaded
C++, any length), whose plain version is `native.levenshtein_batch_plain`,
the JAX package's Python DP.

Score convention: score = (maxlen - dist) / maxlen.
"""

from __future__ import annotations

import numpy as np
import torch


def encode(words, max_len: int):
    """Encode python strings as padded codepoint arrays [N, max_len] +
    lengths. Codepoints, not bytes: one CJK character is one edit."""
    N = len(words)
    arr = np.zeros((N, max_len), np.int32)
    lens = np.zeros(N, np.int32)
    for i, w in enumerate(words):
        cps = [ord(c) for c in w[:max_len]]
        arr[i, : len(cps)] = cps
        lens[i] = len(cps)
    return arr, lens


def levenshtein_matrix(a: torch.Tensor, alen: torch.Tensor, b: torch.Tensor,
                       blen: torch.Tensor) -> torch.Tensor:
    """All-pairs edit distances: a [Q, L], b [T, L] padded codepoints with
    lengths -> dist [Q, T] int32.

    Row i of the DP over b-prefixes is new[j] = min(prev[j] + 1, new[j-1] + 1,
    prev[j-1] + sub) = min_{k <= j} ((j - k) + cand[k]) with cand[0] = i + 1,
    cand[k] = min(prev[k] + 1, prev[k-1] + sub[k-1]). Each query's distance
    is read at its own last row, at column blen[t]."""
    Q, L = a.shape
    T = b.shape[0]
    dev = a.device
    a = a.to(torch.int32)
    b = b.to(torch.int32)
    alen = alen.to(torch.int64)
    blen = blen.to(torch.int64)
    cols = torch.arange(L + 1, dtype=torch.int32, device=dev)
    prev = cols.expand(Q, T, L + 1)
    # alen == 0: the distance is blen
    dist = blen[None, :].expand(Q, T).to(torch.int32)
    col_idx = blen[None, :, None].expand(Q, T, 1)
    for i in range(L):
        sub = (a[:, i, None, None] != b[None, :, :]).to(torch.int32)  # [Q, T, L]
        cand = torch.minimum(prev[..., 1:] + 1, prev[..., :-1] + sub)
        cand = torch.cat([torch.full((Q, T, 1), i + 1, dtype=torch.int32, device=dev), cand],
                         dim=-1)
        new = torch.cummin(cand - cols, dim=-1).values + cols
        last = (alen == i + 1)[:, None]
        dist = torch.where(last, new.gather(-1, col_idx)[..., 0], dist)
        prev = new
    return dist


def similarity_scores(dist: torch.Tensor, alen: torch.Tensor, blen: torch.Tensor) -> torch.Tensor:
    """(maxlen - dist) / maxlen, the reference's word score."""
    maxlen = torch.maximum(alen[:, None], blen[None, :]).clamp(min=1)
    return (maxlen - dist).float() / maxlen.float()
