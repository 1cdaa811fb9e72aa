"""Sim(3) similarity transforms, packed as [..., 8] = [qw qx qy qz tx ty tz s].
Port of textslam_tpu/geometry/sim3.py.

Group ops (compose / inverse / apply), the exp / log maps of the pose-graph
residual and Horn's closed-form alignment, batched over the leading axes.
The guarded branches of `_V_matrix` (small rotation, small log-scale) are
kept exactly: the Sim3 solvers take their Jacobians at zero tangent with
forward-mode AD, and the unselected branch of each `where` never divides by
zero there.
"""

from __future__ import annotations

import torch

from .quaternion import qconj, qexp, qlog, qmul, qnormalize, qrotate

EPS = 1e-12


def identity(shape=(), device=None) -> torch.Tensor:
    S = torch.zeros(tuple(shape) + (8,), device=device)
    S[..., 0] = 1.0
    S[..., 7] = 1.0
    return S


def pack(q: torch.Tensor, t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.cat([q, t, s[..., None] if s.ndim == q.ndim - 1 else s], dim=-1)


def unpack(S: torch.Tensor):
    return S[..., 0:4], S[..., 4:7], S[..., 7]


def from_se3(T: torch.Tensor, s=None) -> torch.Tensor:
    sc = (torch.ones(T.shape[:-1], dtype=T.dtype, device=T.device) if s is None
          else torch.as_tensor(s, dtype=T.dtype, device=T.device))
    return torch.cat([T, sc[..., None]], dim=-1)


def apply(S: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """p' = s R p + t."""
    q, t, s = unpack(S)
    return s[..., None] * qrotate(q, p) + t


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """S = A ∘ B: R = Ra Rb, s = sa sb, t = sa Ra tb + ta."""
    qa, ta, sa = unpack(A)
    qb, tb, sb = unpack(B)
    q = qnormalize(qmul(qa, qb))
    t = sa[..., None] * qrotate(qa, tb) + ta
    s = (sa * sb)[..., None]
    shape = torch.broadcast_shapes(q.shape[:-1], t.shape[:-1], s.shape[:-1])
    return torch.cat([q.expand(shape + (4,)), t.expand(shape + (3,)),
                      s.expand(shape + (1,))], dim=-1)


def inverse(S: torch.Tensor) -> torch.Tensor:
    q, t = S[..., 0:4], S[..., 4:7]
    qi = qconj(q)
    si = 1.0 / S[..., 7:8].clamp(min=EPS)  # [..., 1], not 0-d (see _V_matrix)
    return torch.cat([qi, -si * qrotate(qi, t), si], dim=-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def _V_matrix(omega: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The W matrix of the Sim3 exp / log relating translation and tangent,
    t = W u, in closed form: W = A I + B wx + C wx^2, with the theta -> 0
    and sigma -> 0 limits selected by `where` on safe operands. The scalar
    terms keep a trailing axis of 1: torch.where on 0-d operands under
    torch.func transforms promotes to float64."""
    sigma = sigma[..., None]
    one = torch.ones_like(sigma)
    sq = (omega * omega).sum(dim=-1, keepdim=True)
    small_theta = sq < 1e-12
    theta = torch.sqrt(torch.where(small_theta, one, sq))
    s = torch.exp(sigma)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(omega.shape[:-1] + (3, 3))
    wx = skew(omega)
    wx2 = wx @ wx
    t2 = torch.where(small_theta, one, sq)

    small_sigma = sigma.abs() < 1e-6
    sig_safe = torch.where(small_sigma, one, sigma)

    # A = (s - 1) / sigma  (sigma -> 0: 1)
    A = torch.where(small_sigma, 1.0 + sigma / 2.0, (s - 1.0) / sig_safe)

    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    denom = (sigma * sigma + t2).clamp(min=EPS)
    b_gen = (s * sin_t * sigma + (1.0 - s * cos_t) * theta) / (theta.clamp(min=EPS) * denom)
    c_gen = (A - ((s * cos_t - 1.0) * sigma + s * sin_t * theta) / denom) / t2.clamp(min=EPS)
    # theta -> 0 limits
    b_small = torch.where(small_sigma, 0.5 + sigma / 6.0,
                          (sigma * s - s + 1.0) / torch.where(small_sigma, one, sigma * sigma))
    c_small = torch.where(small_sigma, 1.0 / 6.0 + sigma / 24.0,
                          (s * (0.5 * sigma * sigma - sigma + 1.0) - 1.0)
                          / torch.where(small_sigma, one, sigma ** 3))
    B = torch.where(small_theta, b_small, b_gen)
    C = torch.where(small_theta, c_small, c_gen)
    return A[..., None] * eye + B[..., None] * wx + C[..., None] * wx2


def _solve3(W: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """W^-1 t for [..., 3, 3] W by the adjugate: elementwise, so it needs no
    solver call (no host synchronization on the card) and batches under
    torch.func.vmap / jacfwd, where torch.linalg.solve's batching rule gave
    wrong tangents. W is well conditioned (A I plus terms of the rotation)."""
    a, b, c = W[..., 0, 0], W[..., 0, 1], W[..., 0, 2]
    d, e, f = W[..., 1, 0], W[..., 1, 1], W[..., 1, 2]
    g, h, i = W[..., 2, 0], W[..., 2, 1], W[..., 2, 2]
    adj = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e,
                       f * g - d * i, a * i - c * g, c * d - a * f,
                       d * h - e * g, b * g - a * h, a * e - b * d], dim=-1)
    adj = adj.reshape(W.shape)
    det = (a * adj[..., 0, 0] + b * adj[..., 1, 0] + c * adj[..., 2, 0])[..., None]
    return (adj @ t[..., None])[..., 0] / det


def expm(tangent: torch.Tensor) -> torch.Tensor:
    """sim(3) tangent [..., 7] = (omega 3, u 3, sigma) -> Sim3 [..., 8]."""
    omega = tangent[..., 0:3]
    u = tangent[..., 3:6]
    sigma = tangent[..., 6]
    q = qexp(omega)
    t = (_V_matrix(omega, sigma) @ u[..., None])[..., 0]
    return torch.cat([q, t, torch.exp(sigma)[..., None]], dim=-1)


def logm(S: torch.Tensor) -> torch.Tensor:
    """Sim3 [..., 8] -> tangent [..., 7] = (omega, u, sigma), the residual
    layout of the pose-graph edge."""
    q, t, s = unpack(S)
    omega = qlog(q)
    sigma = torch.log(s.clamp(min=EPS))
    u = _solve3(_V_matrix(omega, sigma), t)
    return torch.cat([omega, u, sigma[..., None]], dim=-1)


def horn_alignment(P1: torch.Tensor, P2: torch.Tensor, w=None, fix_scale: bool = False):
    """Closed-form Sim3 S12 minimizing ||P1 - (s R P2 + t)|| (Horn 1987),
    batched over leading dims: P1, P2 [..., N, 3], w an optional [..., N]
    weight / validity mask. The rotation is the eigenvector of the 4x4 N
    matrix's largest eigenvalue, its sign chosen so that q0 >= 0."""
    if w is None:
        w = torch.ones(P1.shape[:-1], dtype=P1.dtype, device=P1.device)
    wsum = w.sum(dim=-1, keepdim=True).clamp(min=EPS)
    c1 = (w[..., None] * P1).sum(dim=-2) / wsum
    c2 = (w[..., None] * P2).sum(dim=-2) / wsum
    X1 = (P1 - c1[..., None, :]) * w[..., None]
    X2 = P2 - c2[..., None, :]
    M = torch.einsum("...ni,...nj->...ij", X2, X1)  # sum x2 x1^T (maps 2 -> 1)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx,
        Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz,
        Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy,
        Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz,
    ], dim=-1).reshape(M.shape[:-2] + (4, 4))
    _, evecs = torch.linalg.eigh(N)
    q = evecs[..., :, -1]  # largest eigenvalue -> rotation quaternion (w, x, y, z)
    q = qnormalize(torch.where(q[..., 0:1] < 0, -q, q))
    RX2 = qrotate(q[..., None, :], X2)
    num = (w[..., None] * X1 * RX2).sum(dim=(-1, -2))
    den = (w[..., None] * RX2 * RX2).sum(dim=(-1, -2)).clamp(min=EPS)
    s = torch.ones_like(num) if fix_scale else num / den
    t = c1 - s[..., None] * qrotate(q, c2)
    return torch.cat([q, t, s[..., None]], dim=-1)
