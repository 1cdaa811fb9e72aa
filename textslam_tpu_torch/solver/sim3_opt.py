"""Sim3 estimation and pose-graph optimization, port of
textslam_tpu/solver/sim3_opt.py.

- Sim3 RANSAC: Horn's closed form on 3-point sets with symmetric
  reprojection inlier checks, every hypothesis solved in one batched pass.
  Drawing the sets (`ransac_sets`, Gumbel top-3 over the valid rows from a
  torch.Generator) is separate from scoring them (`sim3_ransac_sets`), so a
  caller can hand in sets drawn elsewhere.
- `refine_sim3`: LM refinement of S12 on its 7-dof tangent with Huber
  weights frozen at the linearization point (IRLS), then an inlier recount.
- `solve_pose_graph`: Sim3 pose graph over normal and loop edges, residual
  logSim3(S_meas ∘ S_a ∘ S_b^-1), dense GN over 7N unknowns. The normal
  equations are assembled with the deterministic segment sums of the BA
  solver, so a run repeats exactly on the card.

Jacobians come from torch.func.jacfwd at zero tangent (the JAX version's
jax.jacfwd); accept / reject decisions stay on the device (torch.where), so
no solve synchronizes with the host before it returns.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..geometry import sim3
from ..geometry.camera import project
from .ba import _segment_sum


# ---------------------------------------------------------------------------
# RANSAC


def ransac_sets(gen: torch.Generator, valid: torch.Tensor, n_sets: int = 200) -> torch.Tensor:
    """[n_sets, 3] sample indices over the valid rows: Gumbel keys from
    `gen`, top 3 per set (an invalid row is never picked while 3 valid rows
    exist)."""
    u = torch.rand((n_sets, valid.shape[0]), generator=gen, device=valid.device).clamp(min=1e-30)
    g = torch.where(valid[None, :], -torch.log(-torch.log(u)), torch.full_like(u, -float("inf")))
    return torch.topk(g, 3, dim=-1).indices


def _inliers(S12, P1, P2, uv1, uv2, valid, fx, fy, cx, cy, err2_thresh):
    """Symmetric reprojection inlier mask(s) of S12 [..., 8] -> [..., N]."""
    p1 = sim3.apply(S12[..., None, :], P2)  # P2 -> cam1
    p2 = sim3.apply(sim3.inverse(S12)[..., None, :], P1)
    e1 = ((project(p1, fx, fy, cx, cy) - uv1) ** 2).sum(-1)
    e2 = ((project(p2, fx, fy, cx, cy) - uv2) ** 2).sum(-1)
    return (e1 < err2_thresh) & (e2 < err2_thresh) & (p1[..., 2] > 0) & (p2[..., 2] > 0) & valid


def sim3_ransac_sets(sets, P1, P2, uv1, uv2, valid, fx, fy, cx, cy,
                     err2_thresh: float = 45.0, fix_scale: bool = False):
    """Score the hypotheses of the index sets [S, 3]: the best by inlier
    count, refit by Horn on its inliers (kept when it does not lose
    inliers). P1 [N, 3] camera-1 points matched to P2 [N, 3] camera-2
    points; uv1 / uv2 their pixels. Returns (S12 [8], inliers [N], n)."""
    S = sim3.horn_alignment(P1[sets], P2[sets], fix_scale=fix_scale)  # [S, 8]
    args = (P1, P2, uv1, uv2, valid, fx, fy, cx, cy, err2_thresh)
    inls = _inliers(S, *args)  # [S, N]
    votes = inls.sum(-1)
    best = torch.argmax(votes)
    S_best = S[best]
    S_ref = sim3.horn_alignment(P1, P2, w=inls[best].to(P1.dtype), fix_scale=fix_scale)
    S_out = torch.where(_inliers(S_ref, *args).sum() >= votes[best], S_ref, S_best)
    inl_out = _inliers(S_out, *args)
    return S_out, inl_out, inl_out.sum()


# ---------------------------------------------------------------------------
# Sim3 refinement


def refine_sim3(S12_init, P1, P2, uv1, uv2, valid, fx, fy, cx, cy,
                huber: float = 3.162, n_iters: int = 20, err_thresh: float = 4.0,
                fix_scale: bool = False):
    """LM refinement of S12 on the sim3 tangent (Huber sqrt(10) px on the
    symmetric reprojection); returns (S12, inliers at err_thresh px)."""
    dev = P1.device

    def residuals(S12):
        p1 = sim3.apply(S12[None, :], P2)
        p2 = sim3.apply(sim3.inverse(S12)[None, :], P1)
        r1 = project(p1, fx, fy, cx, cy) - uv1
        r2 = project(p2, fx, fy, cx, cy) - uv2
        ok = valid & (p1[:, 2] > 1e-4) & (p2[:, 2] > 1e-4)
        return torch.cat([r1, r2], dim=-1), ok  # [N, 4]

    def cost_of(S12):
        r, ok = residuals(S12)
        r2 = (r * r).sum(-1)
        rn = torch.sqrt(r2.clamp(min=1e-12))
        c = torch.where(rn <= huber, r2, 2 * huber * rn - huber * huber)
        return torch.where(ok, c, torch.zeros_like(c)).sum()

    scale_mask = torch.ones(7, device=dev)
    if fix_scale:
        scale_mask[6] = 0.0
    z = torch.zeros(7, device=dev)
    S12 = S12_init
    lam = torch.tensor(1e-4, device=dev)
    cost = cost_of(S12)
    for _ in range(n_iters):
        # IRLS: the robust weight is frozen at the linearization point (the
        # JAX version's stop_gradient); differentiating through |r|^-1/2
        # would halve the Jacobian of large residuals and overshoot
        r0, ok0 = residuals(sim3.compose(sim3.expm(z), S12))
        rn0 = torch.sqrt((r0 * r0).sum(-1).clamp(min=1e-12))
        hw = torch.where(rn0 <= huber, torch.ones_like(rn0), torch.sqrt(huber / rn0))
        w = torch.where(ok0, hw, torch.zeros_like(hw))

        def res_tangent(delta):
            r, _ = residuals(sim3.compose(sim3.expm(delta), S12))
            return (r * w[:, None]).reshape(-1)

        J = jacfwd(res_tangent)(z)  # [4N, 7]
        r = res_tangent(z)
        J = torch.where(torch.isfinite(J), J, torch.zeros_like(J))
        r = torch.where(torch.isfinite(r), r, torch.zeros_like(r))
        H = J.T @ J
        b = J.T @ r
        H = H + torch.diag(lam * torch.diagonal(H) + 1e-8)
        H = H + torch.diag((1.0 - scale_mask) * 1e6)
        delta = torch.linalg.solve_ex(H, -b)[0] * scale_mask  # no sync on the card
        S_new = sim3.compose(sim3.expm(delta), S12)
        new_cost = cost_of(S_new)
        accept = (new_cost < cost) & torch.isfinite(new_cost)
        S12 = torch.where(accept, S_new, S12)
        lam = torch.where(accept, lam * 0.3, lam * 5.0).clamp(1e-10, 1e8)
        cost = torch.where(accept, new_cost, cost)
    r, ok = residuals(S12)
    e1 = (r[:, :2] ** 2).sum(-1)
    e2 = (r[:, 2:] ** 2).sum(-1)
    return S12, ok & (e1 < err_thresh ** 2) & (e2 < err_thresh ** 2)


# ---------------------------------------------------------------------------
# Sim3 pose graph


class PoseGraph(NamedTuple):
    nodes: torch.Tensor  # [N, 8] Sim3 S_iw
    fixed: torch.Tensor  # [N] bool
    edge_a: torch.Tensor  # [E] int64
    edge_b: torch.Tensor  # [E] int64
    edge_meas: torch.Tensor  # [E, 8] S_ba measurements (maps a-frame -> b-frame)
    edge_valid: torch.Tensor  # [E] bool
    edge_weight: torch.Tensor  # [E]


def _edge_residual(delta_a, delta_b, Sa, Sb, meas):
    Sa = sim3.compose(sim3.expm(delta_a), Sa)
    Sb = sim3.compose(sim3.expm(delta_b), Sb)
    return sim3.logm(sim3.compose(meas, sim3.compose(Sa, sim3.inverse(Sb))))


def solve_pose_graph(graph: PoseGraph, n_iters: int = 20, lam0: float = 1e-6):
    """Dense GN / LM over Sim3 nodes; residual per edge
    r = logSim3(S_ba_meas ∘ S_aw ∘ S_bw^-1). Returns (nodes [N, 8], cost)."""
    N = graph.nodes.shape[0]
    n = 7 * N
    dev = graph.nodes.device
    z = torch.zeros(7, device=dev)
    jac = vmap(jacfwd(_edge_residual, argnums=(0, 1)), in_dims=(None, None, 0, 0, 0))
    res = vmap(_edge_residual, in_dims=(None, None, 0, 0, 0))
    w = (graph.edge_valid.float() * graph.edge_weight)[:, None]

    def finite(x):
        return torch.where(torch.isfinite(x), x, torch.zeros_like(x))

    def residuals(nodes):
        r = res(z, z, nodes[graph.edge_a], nodes[graph.edge_b], graph.edge_meas)
        return finite(r) * w

    ar7 = torch.arange(7, device=dev)
    ia = graph.edge_a[:, None] * 7 + ar7[None, :]  # [E, 7]
    ib = graph.edge_b[:, None] * 7 + ar7[None, :]

    def blocks(i, j):
        return (i[:, :, None] * n + j[:, None, :]).reshape(-1)

    h_idx = torch.cat([blocks(ia, ia), blocks(ib, ib), blocks(ia, ib), blocks(ib, ia)])
    b_idx = torch.cat([ia.reshape(-1), ib.reshape(-1)])
    free_mask = (~graph.fixed).repeat_interleave(7)
    eye = torch.eye(n, device=dev)

    nodes = graph.nodes
    r0 = residuals(nodes)
    cost = (r0 * r0).sum()
    lam = torch.tensor(lam0, device=dev)
    for _ in range(n_iters):
        Sa, Sb = nodes[graph.edge_a], nodes[graph.edge_b]
        Ja, Jb = jac(z, z, Sa, Sb, graph.edge_meas)  # [E, 7, 7] each
        r = residuals(nodes)
        Ja = finite(Ja) * w[..., None]
        Jb = finite(Jb) * w[..., None]
        Haa = torch.einsum("eri,erj->eij", Ja, Ja)
        Hbb = torch.einsum("eri,erj->eij", Jb, Jb)
        Hab = torch.einsum("eri,erj->eij", Ja, Jb)
        H = _segment_sum(torch.cat([Haa.reshape(-1), Hbb.reshape(-1), Hab.reshape(-1),
                                    Hab.transpose(-1, -2).reshape(-1)]),
                         h_idx, n * n).reshape(n, n)
        b = _segment_sum(torch.cat([torch.einsum("eri,er->ei", Ja, r).reshape(-1),
                                    torch.einsum("eri,er->ei", Jb, r).reshape(-1)]), b_idx, n)
        diag = torch.diagonal(H)
        H = torch.where(free_mask[:, None] & free_mask[None, :], H, torch.zeros_like(H))
        H = H + (lam * torch.where(diag > 1e-12, diag, torch.ones_like(diag)) + 1e-8) * eye
        H = H + torch.diag((~free_mask).float())
        b = torch.where(free_mask, b, torch.zeros_like(b))
        delta = (torch.linalg.solve_ex(H, -b)[0] * free_mask).reshape(N, 7)
        new_nodes = sim3.compose(sim3.expm(delta), nodes)
        new_nodes = torch.where(graph.fixed[:, None], nodes, new_nodes)
        r2 = residuals(new_nodes)
        new_cost = (r2 * r2).sum()
        accept = (new_cost < cost) & torch.isfinite(new_cost)
        nodes = torch.where(accept, new_nodes, nodes)
        lam = torch.where(accept, lam * 0.3, lam * 10.0).clamp(1e-12, 1e8)
        cost = torch.where(accept, new_cost, cost)
    return nodes, cost
