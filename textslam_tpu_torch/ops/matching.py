"""Batched binary descriptor matching, port of textslam_tpu/ops/matching.py.

The whole N1 x N2 Hamming distance matrix comes from one kernel launch
(csrc/hamming.cu on the GPU), the alternate-descriptor minimum included;
spatial windows, level gates and validity are masks on that matrix, and
best-2 + column uniqueness are reductions over it.

Descriptors are int32 [N, 8] tensors holding the bits of 256-bit ORB
descriptors (see ops.orb).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import cuda_lib

INF = 10_000  # > max possible Hamming distance (256)
WORDS = 8  # 32-bit words per 256-bit descriptor
_TILE_ROWS = 64  # rows per block of csrc/hamming.cu
_MAX_ROWS = 65535 * _TILE_ROWS  # CUDA's grid.y limit x rows per block


def launch_args(d1: torch.Tensor, d2: torch.Tensor,
                d1_alt: Optional[torch.Tensor] = None) -> Tuple[int, int]:
    """Check the descriptors (raising on what the kernel does not take) and
    return (N1, N2): pure Python on types, shapes, strides and pointers, no
    tensor op and no device access."""
    named = [("d1", d1), ("d2", d2)] + ([] if d1_alt is None else [("d1_alt", d1_alt)])
    for name, d in named:
        if not isinstance(d, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(d).__name__}")
        if d.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 descriptor bits, got {d.dtype}")
        if d.dim() != 2 or d.shape[1] != WORDS:
            raise ValueError(f"{name} must have shape [N, {WORDS}], got {tuple(d.shape)}")
        if not d.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if d.data_ptr() % 16:  # the kernel reads a descriptor as two 16-byte vectors
            raise ValueError(f"{name} must be 16-byte aligned")
        if d is not d1 and d.device != d1.device:
            raise ValueError(f"d1 on {d1.device} but {name} on {d.device}")
    if d1_alt is not None and d1_alt.shape != d1.shape:
        raise ValueError(f"d1_alt {tuple(d1_alt.shape)} must have d1's shape {tuple(d1.shape)}")
    n1, n2 = d1.shape[0], d2.shape[0]
    if n1 > _MAX_ROWS:
        raise ValueError(f"hamming_matrix takes at most {_MAX_ROWS} rows, got {n1}")
    return n1, n2


def hamming_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances between [N1, 8] and [N2, 8] int32
    descriptors -> [N1, N2] int32.

    CUDA tensors launch the hand-written kernel (csrc/hamming.cu) and count
    the launch in `hamming_matrix.launches`; CPU tensors take the plain
    version. Anything else raises: there is no fallback from the kernel to
    the plain version."""
    launch_args(d1, d2)
    if d1.is_cuda:
        return _hamming_cuda(d1, d2)
    _require_cpu(d1)
    return hamming_matrix_plain(d1, d2)


def hamming_matrix_min(d1: torch.Tensor, d1_alt: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """min(hamming_matrix(d1, d2), hamming_matrix(d1_alt, d2)) in one
    launch of the same kernel, counted in `hamming_matrix.launches`; the
    same contract as hamming_matrix."""
    launch_args(d1, d2, d1_alt)
    if d1.is_cuda:
        return _hamming_cuda(d1, d2, d1_alt)
    _require_cpu(d1)
    return hamming_matrix_min_plain(d1, d1_alt, d2)


def _require_cpu(d: torch.Tensor) -> None:
    """The plain version is for CPU tensors only: any other device raises."""
    if d.device.type != "cpu":
        raise RuntimeError(f"hamming_matrix has no kernel for device {d.device}")


def _hamming_cuda(d1: torch.Tensor, d2: torch.Tensor,
                  d1_alt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch csrc/hamming.cu on the current stream of d1's device. Raises
    when nvcc is missing, the build fails or the launch is refused."""
    n1, n2 = d1.shape[0], d2.shape[0]
    out = d1.new_empty((n1, n2))
    cuda_lib.launch("hamming", "hamming_matrix_launch", d1.device, d1.data_ptr(),
                    None if d1_alt is None else d1_alt.data_ptr(), d2.data_ptr(),
                    out.data_ptr(), n1, n2)
    hamming_matrix.launches += 1
    return out


hamming_matrix.launches = 0


def _bits(d: torch.Tensor) -> torch.Tensor:
    """[N, 8] int32 descriptors -> [N, 256] float32 0/1 bits."""
    w = d.long() & 0xFFFFFFFF
    shifts = torch.arange(32, device=d.device)
    return ((w[:, :, None] >> shifts) & 1).reshape(d.shape[0], WORDS * 32).float()


def hamming_matrix_plain(d1: torch.Tensor, d2: torch.Tensor,
                         chunk_elems: int = 1 << 22) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: H = popc(a) + popc(b) - 2 popc(a AND
    b), with popc(a AND b) a float32 product of the 0/1 bit matrices (the
    kernel's binary MMA; sums of at most 256 ones are exact in float32).
    Rows go in chunks of `chunk_elems` // (N2 * 8) to bound memory."""
    n1, n2 = d1.shape[0], d2.shape[0]
    b2 = _bits(d2)
    pop2 = b2.sum(-1)
    out = torch.empty((n1, n2), dtype=torch.int32, device=d1.device)
    rows = max(1, chunk_elems // max(n2 * WORDS, 1))
    for s in range(0, n1, rows):
        b1 = _bits(d1[s : s + rows])
        both = b1 @ b2.T
        out[s : s + rows] = (b1.sum(-1)[:, None] + pop2[None, :] - 2 * both).to(torch.int32)
    return out


def hamming_matrix_min_plain(d1: torch.Tensor, d1_alt: torch.Tensor,
                             d2: torch.Tensor) -> torch.Tensor:
    """Plain twin of hamming_matrix_min."""
    return torch.minimum(hamming_matrix_plain(d1, d2), hamming_matrix_plain(d1_alt, d2))


def masked_best2(dist: torch.Tensor, mask: torch.Tensor):
    """Best and second-best matches along axis 1 under a validity mask.

    Returns (best_idx [N1], best_d [N1], second_d [N1]); invalid pairs get
    distance INF. Ties are the normal case for small-integer distances: the
    best index is the FIRST minimum (what XLA's top_k returns), and the
    second distance is the minimum with that one column masked out."""
    d = torch.where(mask, dist, INF)
    best_idx = torch.argmin(d, dim=1)
    best_d = d.gather(1, best_idx[:, None])[:, 0]
    second_d = d.scatter(1, best_idx[:, None], INF).amin(dim=1)
    return best_idx, best_d, second_d


def window_mask(uv1: torch.Tensor, uv2: torch.Tensor, radius) -> torch.Tensor:
    """[N1, N2] mask: |u1-u2|<=r and |v1-v2|<=r. radius may be scalar or
    per-row [N1] (the reference scales the window by octave)."""
    du = (uv1[:, None, 0] - uv2[None, :, 0]).abs()
    dv = (uv1[:, None, 1] - uv2[None, :, 1]).abs()
    if isinstance(radius, torch.Tensor) and radius.dim() == 1:
        radius = radius[:, None]
    return (du <= radius) & (dv <= radius)


def level_mask(l1: torch.Tensor, l2: torch.Tensor, max_diff: Optional[int] = 0) -> torch.Tensor:
    """[N1, N2] mask of pyramid-level agreement (None -> all True)."""
    if max_diff is None:
        return torch.ones((l1.shape[0], l2.shape[0]), dtype=torch.bool, device=l1.device)
    return (l1[:, None] - l2[None, :]).abs() <= max_diff


def rotation_histogram_filter(angles1, angles2, match_idx, match_ok, n_bins: int = 30, keep_bins: int = 3):
    """Rotation-consistency check: keep only matches whose angle difference
    falls into the `keep_bins` most populated histogram bins (ties between
    bins resolve to the lower bin, as XLA's top_k does)."""
    da = angles1 - angles2[match_idx]
    two_pi = 2.0 * torch.pi
    da = torch.remainder(da, two_pi)
    bin_idx = torch.floor(da / (two_pi / n_bins)).long() % n_bins
    counts = torch.zeros(n_bins, dtype=torch.int32, device=da.device).index_add_(
        0, bin_idx, match_ok.int())
    top_bins = torch.sort(counts, descending=True, stable=True).indices[:keep_bins]
    in_top = (bin_idx[:, None] == top_bins[None, :]).any(dim=-1)
    return match_ok & in_top


def mutual_best_match(
    d1: torch.Tensor,
    d2: torch.Tensor,
    valid1: torch.Tensor,
    valid2: torch.Tensor,
    pair_mask: Optional[torch.Tensor] = None,
    max_dist: int = 50,
    ratio: Optional[float] = None,
    d1_alt: Optional[torch.Tensor] = None,
):
    """One-shot matcher: best2 along rows + uniqueness along columns.

    Returns (idx2 [N1] int64, ok [N1] bool): idx2[i] is the match of d1[i].
    Column collisions keep the row with the smaller distance, and among equal
    distances the highest row (the JAX package's scatter-min / scatter-max).
    d1_alt supplies a second descriptor per row, matched as min(d, d_alt)."""
    mask = valid1[:, None] & valid2[None, :]
    if pair_mask is not None:
        mask = mask & pair_mask
    dist = hamming_matrix(d1, d2) if d1_alt is None else hamming_matrix_min(d1, d1_alt, d2)
    idx2, best_d, second_d = masked_best2(dist, mask)
    ok = best_d <= max_dist
    if ratio is not None:
        ok = ok & (best_d.float() < ratio * second_d.float())
    n1, n2 = dist.shape
    rows = torch.arange(n1, device=dist.device)
    claim_d = torch.where(ok, best_d, INF)
    col_best = torch.full((n2,), INF, dtype=claim_d.dtype, device=dist.device).scatter_reduce(
        0, idx2, claim_d, "amin", include_self=True)
    col_winner = torch.full((n2,), -1, dtype=torch.int64, device=dist.device).scatter_reduce(
        0, idx2, torch.where(claim_d == col_best[idx2], rows, -1), "amax", include_self=True)
    ok = ok & (col_winner[idx2] == rows)
    return idx2, ok
