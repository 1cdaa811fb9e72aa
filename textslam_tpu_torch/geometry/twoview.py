"""Two-view relative-pose bootstrap: batched H/F RANSAC + reconstruction,
port of textslam_tpu/geometry/twoview.py.

All 200 hypotheses are solved in one batched SVD and scored in one
[hyp, N] pass; reconstruction hypotheses (4 for F via the essential matrix,
8 for H via Faugeras) are checked as a small batch.

Differences from the JAX version, both where its result is not defined by
the math but by the library:
- RANSAC sets come from a seeded torch.Generator (Gumbel top-k), which
  cannot reproduce JAX's random bits; compare this stage by outcome.
- A homography is normalized by its H22 with the sign kept. The JAX version
  clips H22 from below at 1e-12, so a hypothesis whose SVD null vector came
  out with the other sign is scaled by 1e12 and scores as garbage; which
  hypotheses that hits depends on the LAPACK's sign convention.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import se3, triangulate
from .quaternion import qfrom_matrix

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991  # both models accumulate (SCORE_TH - err) per inlier


def _svd(A: torch.Tensor, full_matrices: bool = False):
    """torch.linalg.svd with jnp.linalg.svd's NaN-in / NaN-out semantics:
    LAPACK refuses non-finite input, so such matrices are zeroed for the
    call and their factors set to NaN."""
    bad = ~torch.isfinite(A).all(dim=-1).all(dim=-1)
    U, S, Vh = torch.linalg.svd(torch.where(bad[..., None, None], 0.0, A),
                                full_matrices=full_matrices)
    nan = float("nan")
    return (torch.where(bad[..., None, None], nan, U), torch.where(bad[..., None], nan, S),
            torch.where(bad[..., None, None], nan, Vh))


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """Right singular vector of the smallest singular value of A [..., R, 9]."""
    return _svd(A, full_matrices=A.shape[-2] < A.shape[-1])[2][..., -1, :]


def _normalize(pts: torch.Tensor):
    """Hartley normalization. pts [..., N, 2] -> (normed, T [..., 3, 3])."""
    mean = pts.mean(dim=-2, keepdim=True)
    d = (pts - mean).abs().mean(dim=-2, keepdim=True).clamp(min=1e-8)
    s = 1.0 / d
    normed = (pts - mean) * s
    sx, sy = s[..., 0, 0], s[..., 0, 1]
    mx, my = mean[..., 0, 0], mean[..., 0, 1]
    zeros = torch.zeros_like(sx)
    ones = torch.ones_like(sx)
    T = torch.stack(
        [sx, zeros, -mx * sx, zeros, sy, -my * sy, zeros, zeros, ones], dim=-1
    ).reshape(pts.shape[:-2] + (3, 3))
    return normed, T


def solve_h_8pt(p1: torch.Tensor, p2: torch.Tensor, w=None) -> torch.Tensor:
    """DLT homography p2 ~ H p1 from [..., N, 2] point sets -> [..., 3, 3].
    Optional w [..., N] row weights (0 = excluded) for inlier refits."""
    n1, T1 = _normalize(p1)
    n2, T2 = _normalize(p2)
    x, y = n1[..., 0], n1[..., 1]
    u, v = n2[..., 0], n2[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    r1 = torch.stack([zeros, zeros, zeros, -x, -y, -ones, v * x, v * y, v], dim=-1)
    r2 = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y, -u], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # [..., 2N, 9]
    if w is not None:
        A = A * torch.cat([w, w], dim=-1)[..., None]
    Hn = _null_vector(A).reshape(p1.shape[:-2] + (3, 3))
    H = torch.linalg.solve_ex(T2, Hn @ T1).result
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(h22.abs() < 1e-12, torch.full_like(h22, 1e-12), h22)


def solve_f_8pt(p1: torch.Tensor, p2: torch.Tensor, w=None) -> torch.Tensor:
    """8-point fundamental matrix (rank-2 enforced), p2^T F p1 = 0; any
    N >= 8, optional w [..., N] row weights for inlier refits."""
    n1, T1 = _normalize(p1)
    n2, T2 = _normalize(p2)
    x, y = n1[..., 0], n1[..., 1]
    u, v = n2[..., 0], n2[..., 1]
    ones = torch.ones_like(x)
    A = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, ones], dim=-1)
    if w is not None:
        A = A * w[..., None]
    Fn = _null_vector(A).reshape(p1.shape[:-2] + (3, 3))
    U, S, Vt2 = _svd(Fn)
    S2 = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    Fr = U @ (S2[..., None] * Vt2)
    return T2.transpose(-1, -2) @ Fr @ T1


def _homog(p):
    return torch.cat([p, torch.ones(p.shape[:-1] + (1,), device=p.device)], dim=-1)


def score_h(H: torch.Tensor, p1, p2, valid, sigma: float = 1.0):
    """Symmetric transfer error score of homography hypotheses.

    H [..., 3, 3], p1/p2 [N, 2], valid [N] -> (score [...], inlier [..., N])."""
    Hi = torch.linalg.inv_ex(H).inverse
    x1 = _homog(p1)
    x2 = _homog(p2)
    q2 = torch.einsum("...ij,nj->...ni", H, x1)
    q1 = torch.einsum("...ij,nj->...ni", Hi, x2)
    e12 = ((q2[..., :2] / q2[..., 2:3].clamp(min=1e-12) - p2) ** 2).sum(-1) / sigma**2
    e21 = ((q1[..., :2] / q1[..., 2:3].clamp(min=1e-12) - p1) ** 2).sum(-1) / sigma**2
    in12 = e12 < CHI2_H
    in21 = e21 < CHI2_H
    sc = torch.where(in12, SCORE_TH - e12, 0.0) + torch.where(in21, SCORE_TH - e21, 0.0)
    inlier = in12 & in21 & valid
    return (sc * valid).sum(-1), inlier


def score_f(F: torch.Tensor, p1, p2, valid, sigma: float = 1.0):
    """Point-to-epipolar-line error score of fundamental hypotheses."""
    x1 = _homog(p1)
    x2 = _homog(p2)
    l2 = torch.einsum("...ij,nj->...ni", F, x1)  # line in image 2
    l1 = torch.einsum("...ji,nj->...ni", F, x2)  # line in image 1
    d2 = (x2 * l2).sum(-1) ** 2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2).clamp(min=1e-12) / sigma**2
    d1 = (x1 * l1).sum(-1) ** 2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2).clamp(min=1e-12) / sigma**2
    in2 = d2 < CHI2_F
    in1 = d1 < CHI2_F
    sc = torch.where(in2, SCORE_TH - d2, 0.0) + torch.where(in1, SCORE_TH - d1, 0.0)
    inlier = in1 & in2 & valid
    return (sc * valid).sum(-1), inlier


def ransac_sets(gen: torch.Generator, n_points: int, valid: torch.Tensor, n_sets: int = 200, k: int = 8):
    """Draw [n_sets, k] sample indices restricted to valid matches, by
    Gumbel top-k (invalid entries are never picked while k valid exist).
    Deterministic under a seeded generator."""
    u = torch.rand((n_sets, n_points), generator=gen, device=valid.device)
    g = -torch.log(-torch.log(u))
    g = torch.where(valid[None, :], g, float("-inf"))
    return torch.topk(g, k, dim=-1).indices


class TwoViewResult(NamedTuple):
    success: torch.Tensor  # bool
    used_h: torch.Tensor  # bool
    T21: torch.Tensor  # [7] pose of cam2 w.r.t cam1 (world = cam1)
    points: torch.Tensor  # [N, 3] triangulated in cam1 frame
    is_inlier: torch.Tensor  # [N]
    score_ratio: torch.Tensor  # RH


def _rt_hypotheses_from_F(F, K):
    """E = K^T F K -> 4 (R, t) candidates [4, 3, 4]."""
    E = K.T @ F @ K
    U, _, Vt = _svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], device=F.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    t = t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp(min=1e-12)
    return torch.stack([
        torch.cat([R1, t[..., None]], dim=-1),
        torch.cat([R1, -t[..., None]], dim=-1),
        torch.cat([R2, t[..., None]], dim=-1),
        torch.cat([R2, -t[..., None]], dim=-1),
    ])


def _rt_hypotheses_from_H(H, K):
    """Faugeras 1988 homography decomposition -> 8 (R, t) candidates
    (the ORB-SLAM-style construction of the reference's ReconstructH)."""
    dev = H.device
    A = torch.linalg.solve_ex(K, H @ K).result
    U, S, Vt = _svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = S[0], S[1], S[2]

    aux1 = torch.sqrt(((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3).clamp(min=1e-12)).clamp(min=0.0))
    aux3 = torch.sqrt(((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3).clamp(min=1e-12)).clamp(min=0.0))
    x1s = torch.tensor([1.0, 1.0, -1.0, -1.0], device=dev) * aux1
    x3s = torch.tensor([1.0, -1.0, 1.0, -1.0], device=dev) * aux3
    signs = (1.0, -1.0, -1.0, 1.0)

    outs = []
    # case d' = +d2
    aux_st = (torch.sqrt(((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3)).clamp(min=0.0))
              / ((d1 + d3) * d2).clamp(min=1e-12))
    ct = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2).clamp(min=1e-12)
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)
    for i in range(4):
        st = aux_st * signs[i]
        Rp = torch.stack([
            torch.stack([ct, zero, -st]),
            torch.stack([zero, one, zero]),
            torch.stack([st, zero, ct]),
        ])
        R = s * U @ Rp @ Vt
        t = U @ (torch.stack([x1s[i], zero, -x3s[i]]) * (d1 - d3))
        outs.append(torch.cat([R, (t / torch.linalg.vector_norm(t).clamp(min=1e-12))[:, None]], dim=-1))
    # case d' = -d2
    aux_sp = (torch.sqrt(((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3)).clamp(min=0.0))
              / ((d1 - d3) * d2).clamp(min=1e-12))
    cp = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2).clamp(min=1e-12)
    for i in range(4):
        sp = aux_sp * signs[i]
        Rp = torch.stack([
            torch.stack([cp, zero, sp]),
            torch.stack([zero, -one, zero]),
            torch.stack([sp, zero, -cp]),
        ])
        R = s * U @ Rp @ Vt
        t = U @ (torch.stack([x1s[i], zero, x3s[i]]) * (d1 + d3))
        outs.append(torch.cat([R, (t / torch.linalg.vector_norm(t).clamp(min=1e-12))[:, None]], dim=-1))
    return torch.stack(outs)  # [8, 3, 4]


def _check_rt(Rt, ray1, ray2, valid, fx, fy, cx, cy, uv1, uv2, max_err2: float = 16.0):
    """Cheirality + reprojection vote for candidate motions.

    Rt [M, 3, 4]; rays/uv [N, ...]. Returns (ngood [M], P3D [M, N, 3],
    good [M, N])."""
    M = Rt.shape[0]
    dev = Rt.device
    q = qfrom_matrix(Rt[..., :3])
    T2 = se3.pack(q, Rt[..., 3])  # [M, 7] cam2 pose (world=cam1)
    T1 = se3.identity((M,), device=dev)
    P = triangulate.triangulate(
        ray1.expand((M,) + ray1.shape),
        ray2.expand((M,) + ray2.shape),
        T1[:, None, :],
        T2[:, None, :],
    )  # [M, N, 3]
    z1 = P[..., 2]
    z2 = triangulate.depths(P, T2[:, None, :])
    C2 = se3.apply(se3.inverse(T2), torch.zeros((M, 3), device=dev))  # cam2 center
    pcos = triangulate.parallax_cos(P, torch.zeros(3, device=dev), C2[:, None, :])
    e1 = triangulate.reproj_err2(P, T1[:, None, :], uv1, fx, fy, cx, cy)
    e2 = triangulate.reproj_err2(P, T2[:, None, :], uv2, fx, fy, cx, cy)
    finite = torch.isfinite(P).all(-1)
    good = (
        valid[None, :]
        & finite
        & (z1 > 0)
        & (z2 > 0)
        & (e1 < max_err2)
        & (e2 < max_err2)
        & (pcos < 0.99998)  # ~0.36deg min parallax, as in CheckRT
    )
    return good.sum(-1), P, good


def initialize_two_view(
    gen: torch.Generator,
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    valid: torch.Tensor,
    fx, fy, cx, cy,
    n_sets: int = 200,
    sigma: float = 1.0,
    min_inliers: int = 50,
    min_triangulated_frac: float = 0.5,
) -> TwoViewResult:
    """Full two-view bootstrap on matched pixel pairs (padded, masked):
    joint H/F RANSAC, RH model selection at 0.40, then motion reconstruction
    with a cheirality vote. Returns pose T21 with ||t|| = 1."""
    dev = uv1.device
    K = torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], device=dev)
    idx = ransac_sets(gen, uv1.shape[0], valid, n_sets=n_sets)
    s1 = uv1[idx]  # [S, 8, 2]
    s2 = uv2[idx]
    Hs = solve_h_8pt(s1, s2)
    Fs = solve_f_8pt(s1, s2)
    sh, _ = score_h(Hs, uv1, uv2, valid, sigma)
    sf, _ = score_f(Fs, uv1, uv2, valid, sigma)
    bh = torch.argmax(sh)
    bf = torch.argmax(sf)
    SH, SF = sh[bh], sf[bf]
    Hbest, Fbest = Hs[bh], Fs[bf]
    _, inl_h = score_h(Hbest, uv1, uv2, valid, sigma)
    _, inl_f = score_f(Fbest, uv1, uv2, valid, sigma)
    # refit each model on all of its inliers (weighted rows, fixed shapes)
    Hbest = solve_h_8pt(uv1, uv2, w=inl_h.to(uv1.dtype))
    Fbest = solve_f_8pt(uv1, uv2, w=inl_f.to(uv1.dtype))
    _, inl_h = score_h(Hbest, uv1, uv2, valid, sigma)
    _, inl_f = score_f(Fbest, uv1, uv2, valid, sigma)
    RH = SH / (SH + SF).clamp(min=1e-12)
    use_h = RH > 0.40

    ones = torch.ones(uv1.shape[0], device=dev)
    ray1 = torch.stack([(uv1[:, 0] - cx) / fx, (uv1[:, 1] - cy) / fy, ones], -1)
    ray2 = torch.stack([(uv2[:, 0] - cx) / fx, (uv2[:, 1] - cy) / fy, ones], -1)

    RtH = _rt_hypotheses_from_H(Hbest, K)  # [8,3,4]
    RtF = _rt_hypotheses_from_F(Fbest, K)  # [4,3,4]
    RtF = torch.cat([RtF, RtF], dim=0)  # pad to 8 for a single vote shape
    Rt = torch.where(use_h, RtH, RtF)
    inl = torch.where(use_h, inl_h, inl_f)
    ngood, P, good = _check_rt(Rt, ray1, ray2, inl, fx, fy, cx, cy, uv1, uv2, max_err2=4.0 * sigma**2)
    # F only has 4 real hypotheses; slots 4..7 are duplicates — kill their votes
    dup = (torch.arange(8, device=dev) >= 4) & ~use_h
    ngood = torch.where(dup, 0, ngood)
    best = torch.argmax(ngood)
    nbest = ngood[best]
    # winner must dominate: second best clearly lower (ORB-SLAM 0.75 factor)
    second = torch.sort(ngood, descending=True).values[1]
    n_inl = inl.sum()
    success = (
        (nbest >= min_inliers)
        & (second < 0.75 * nbest)
        & (nbest >= min_triangulated_frac * n_inl.clamp(min=1))
    )
    q = qfrom_matrix(Rt[best, :, :3])
    T21 = se3.pack(q, Rt[best, :, 3])
    return TwoViewResult(
        success=success,
        used_h=use_h,
        T21=T21,
        points=P[best],
        is_inlier=good[best],
        score_ratio=RH,
    )
