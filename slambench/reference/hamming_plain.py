"""Plain Hamming distances between 256-bit binary descriptors: XOR of the
bytes and a population count by table, in plain PyTorch on any device. It
imports nothing of the program."""

from __future__ import annotations

import torch

_POP8 = [bin(i).count("1") for i in range(256)]


def hamming(d1: torch.Tensor, d2: torch.Tensor, d1_alt=None, rows: int = 256) -> torch.Tensor:
    """[N1, N2] int32 distances between [N1, 8] and [N2, 8] int32 descriptor
    words; with d1_alt, the smaller of the two rows' distances."""
    pop = torch.tensor(_POP8, dtype=torch.int32, device=d1.device)
    b2 = d2.contiguous().view(torch.uint8).reshape(len(d2), 32).long()
    out = torch.empty((len(d1), len(d2)), dtype=torch.int32, device=d1.device)
    sides = [d1] if d1_alt is None else [d1, d1_alt]
    for s in range(0, len(d1), rows):
        best = None
        for d in sides:
            b1 = d[s:s + rows].contiguous().view(torch.uint8).reshape(-1, 32).long()
            h = pop[b1[:, None, :] ^ b2[None, :, :]].sum(-1, dtype=torch.int32)
            best = h if best is None else torch.minimum(best, h)
        out[s:s + rows] = best
    return out
