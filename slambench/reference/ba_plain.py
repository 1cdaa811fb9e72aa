"""Plain bundle adjustment of a scene problem, the reference of the track
step's pose solve and of the windowed BA: the robust reprojection cost of
inverse-depth points, and a Levenberg-Marquardt solve of it on the
solver's own schedule (its step count and damping), in plain PyTorch (Jacobians by forward-mode autodiff, the normal equations
dense). It imports nothing of the program.

A problem is a dict of plain tensors, as the program handed them to its
solver: `poses` [K, 7] Tcw (qw qx qy qz t), `pose_free` [K], `rho` [P],
`rho_free` [P], and per observation `tgt` [O] (window slot of the observing
camera), `host` [O] (window slot of the point's host camera), `host_pose`
[O, 7] and `host_in_window` [O] (a host outside the window keeps that
pose), `point` [O] (index into rho), `ray` [O, 3] (the point's ray in its
host, z = 1), `uv` [O, 2], `weight` [O] (1 / sigma in pixels), `valid` [O];
and the intrinsics `fx`, `fy`, `cx`, `cy` and the Huber threshold `huber`.

The cost of an observation is the Huber cost of its weighted residual
w (K(p_c) - uv), with p_c = R_t R_h^T (ray / rho - t_h) + t_t; an
observation that is valid but has its point behind a camera (z <= 1e-4) or
at a non-positive inverse depth (rho <= 1e-6) costs BROKEN.
"""

from __future__ import annotations

import math

import torch

BROKEN = 1.0e4


def qmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w x y z) -> [..., 3, 3]."""
    q = q / q.norm(dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1
    ).reshape(q.shape[:-1] + (3, 3))


def skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([z, -v[..., 2], v[..., 1], v[..., 2], z, -v[..., 0],
                        -v[..., 1], v[..., 0], z], -1).reshape(v.shape[:-1] + (3, 3))


def rodrigues(phi: torch.Tensor) -> torch.Tensor:
    """exp([phi]x), [..., 3] -> [..., 3, 3]."""
    th = phi.norm(dim=-1, keepdim=True)[..., None]
    K = skew(phi)
    small = th < 1e-12
    th_s = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, torch.ones_like(th), torch.sin(th_s) / th_s)
    b = torch.where(small, torch.full_like(th, 0.5), (1 - torch.cos(th_s)) / th_s ** 2)
    return torch.eye(3, dtype=phi.dtype, device=phi.device) + a * K + b * (K @ K)


def _state(prob: dict, dtype) -> tuple:
    """(R [K, 3, 3], t [K, 3], rho [P]) of the problem's own poses."""
    p = prob["poses"].to(dtype)
    return qmat(p[:, :4]), p[:, 4:], prob["rho"].to(dtype)


def state_of(prob: dict, poses: torch.Tensor, rho: torch.Tensor, dtype=torch.float64) -> tuple:
    """(R, t, rho) of other poses [K, 7] and inverse depths [P]."""
    p = poses.to(dtype)
    return qmat(p[:, :4]), p[:, 4:], rho.to(dtype)


def _rows(prob: dict, R, t, dtype):
    """Per observation: (R_t, t_t, R_h, t_h) at the state (R, t)."""
    K = R.shape[0]
    tgt, host = prob["tgt"], prob["host"]
    hin = prob["host_in_window"]
    hp = prob["host_pose"].to(dtype)
    R_h = torch.where(hin[:, None, None], R[host.clamp(max=K - 1)], qmat(hp[:, :4]))
    t_h = torch.where(hin[:, None], t[host.clamp(max=K - 1)], hp[:, 4:])
    return R[tgt], t[tgt], R_h, t_h


def _project(prob, R_t, t_t, R_h, t_h, ray, rho_o):
    p_w = ((ray / rho_o[..., None]) - t_h)[..., None, :] @ R_h  # R_h^T (p_h - t_h), as a row
    p_c = (p_w @ R_t.transpose(-1, -2))[..., 0, :] + t_t
    u = prob["fx"] * p_c[..., 0] / p_c[..., 2] + prob["cx"]
    v = prob["fy"] * p_c[..., 1] / p_c[..., 2] + prob["cy"]
    return torch.stack([u, v], -1), p_c[..., 2]


def residuals(prob: dict, state: tuple, dtype=torch.float64):
    """(weighted residuals [O, 2], ok [O]) at state (R, t, rho)."""
    R, t, rho = state
    R_t, t_t, R_h, t_h = _rows(prob, R, t, dtype)
    rho_o = rho[prob["point"]]
    uv, z = _project(prob, R_t, t_t, R_h, t_h, prob["ray"].to(dtype), rho_o)
    r = (uv - prob["uv"].to(dtype)) * prob["weight"].to(dtype)[:, None]
    ok = prob["valid"] & (z > 1e-4) & (rho_o > 1e-6)
    return torch.where(ok[:, None], r, torch.zeros_like(r)), ok


def cost(prob: dict, state: tuple, dtype=torch.float64) -> float:
    """The problem's robust cost at state (R, t, rho)."""
    r, ok = residuals(prob, state, dtype)
    r2 = (r * r).sum(-1)
    rn = r2.clamp(min=1e-24).sqrt()
    d = float(prob["huber"])
    c = torch.where(rn <= d, r2, 2 * d * rn - d * d)
    c = torch.where(ok, c, torch.where(prob["valid"], torch.full_like(c, BROKEN),
                                       torch.zeros_like(c)))
    return float(c.to(torch.float64).sum())


def _columns(prob: dict):
    """Column of each observation's 13 local parameters (tangent of its
    target pose, of its host pose, its inverse depth) in the free
    parameters, -1 where fixed; and the number of free parameters."""
    dev = prob["tgt"].device
    free = prob["pose_free"]
    K = free.shape[0]
    slot = torch.full((K + 1,), -1, dtype=torch.int64, device=dev)
    slot[:K][free] = torch.arange(int(free.sum()), device=dev)
    n_pose = 6 * int(free.sum())
    obs_pt = prob["point"][prob["valid"] & prob["rho_free"][prob["point"]]]
    pts = torch.unique(obs_pt)
    pcol = torch.full((prob["rho"].shape[0],), -1, dtype=torch.int64, device=dev)
    pcol[pts] = n_pose + torch.arange(len(pts), device=dev)
    six = torch.arange(6, device=dev)
    st = slot[prob["tgt"]]
    sh = torch.where(prob["host_in_window"], slot[prob["host"].clamp(max=K)], -1)
    ct = torch.where(st[:, None] >= 0, st[:, None] * 6 + six, -1)
    ch = torch.where(sh[:, None] >= 0, sh[:, None] * 6 + six, -1)
    cr = torch.where(prob["rho_free"][prob["point"]], pcol[prob["point"]], -1)[:, None]
    return torch.cat([ct, ch, cr], 1), n_pose + len(pts), pts


def _jacobians(prob: dict, state: tuple, dtype):
    """[O, 2, 13] Jacobians of the weighted residuals in the local
    parameters: R <- (I + [d]x) R, t <- t + dt, rho <- rho + drho."""
    R, t, rho = state
    R_t, t_t, R_h, t_h = _rows(prob, R, t, dtype)
    ray = prob["ray"].to(dtype)
    rho_o = rho[prob["point"]]
    eye = torch.eye(3, dtype=dtype, device=R.device)

    def one(x, R_t, t_t, R_h, t_h, ray, rho_o):
        uv, _ = _project(prob, (eye + skew(x[:3])) @ R_t, t_t + x[3:6],
                         (eye + skew(x[6:9])) @ R_h, t_h + x[9:12], ray, rho_o + x[12])
        return uv

    x0 = torch.zeros(13, dtype=dtype, device=R.device)
    J = torch.func.vmap(torch.func.jacfwd(one), in_dims=(None, 0, 0, 0, 0, 0, 0))(
        x0, R_t, t_t, R_h, t_h, ray, rho_o)
    return J.to(dtype) * prob["weight"].to(dtype)[:, None, None]


def _apply(prob: dict, state: tuple, delta: torch.Tensor, pts: torch.Tensor, storage=None):
    R, t, rho = state
    free = prob["pose_free"]
    d = delta[: 6 * int(free.sum())].reshape(-1, 6)
    R, t, rho = R.clone(), t.clone(), rho.clone()
    R[free] = rodrigues(d[:, :3]) @ R[free]
    t[free] = t[free] + d[:, 3:]
    rho[pts] = rho[pts] + delta[6 * int(free.sum()):]
    if storage is not None:  # the parameters kept at a lower precision
        R, t, rho = (a.to(storage).to(R.dtype) for a in (R, t, rho))
    return R, t, rho


def _system(prob: dict, state: tuple, cols: torch.Tensor, n: int, dtype):
    """The Gauss-Newton system (H [n, n], b [n]) at `state`, the rows
    reweighted for the Huber loss."""
    r, ok = residuals(prob, state, dtype)
    J = _jacobians(prob, state, dtype)
    J = torch.where(ok[:, None, None] & (cols[:, None, :] >= 0), J, torch.zeros_like(J))
    rn = (r * r).sum(-1).clamp(min=1e-24).sqrt()
    d = float(prob["huber"])
    # the solver's weighting: the square root of the Huber weight, applied
    # once to the rows' products (not the Huber cost's own gradient, whose
    # weight is d / |r|: the solver stops short of that cost's minimum)
    w = torch.where(rn <= d, torch.ones_like(rn), (d / rn).sqrt())
    c = torch.where(cols >= 0, cols, n)
    H = torch.zeros((n + 1) * (n + 1), dtype=dtype, device=J.device)
    H.index_add_(0, (c[:, :, None] * (n + 1) + c[:, None, :]).reshape(-1),
                 torch.einsum("oki,okj,o->oij", J, J, w).reshape(-1))
    b = torch.zeros(n + 1, dtype=dtype, device=J.device)
    b.index_add_(0, c.reshape(-1), torch.einsum("oki,ok,o->oi", J, r, w).reshape(-1))
    return H.reshape(n + 1, n + 1)[:n, :n], b[:n]


def solve(prob: dict, n_iters: int, lam0: float = 1e-4, lam_up: float = 10.0,
          lam_down: float = 0.1, lam_min: float = 1e-12, lam_max: float = 1e8,
          dtype=torch.float64, storage=None) -> tuple:
    """Levenberg-Marquardt from the problem's own state, `n_iters` steps
    with the solver's schedule: a trial is accepted when its cost is below
    the best so far (the start always is), the damping then falls by
    `lam_down`, else it rises by `lam_up`, within [lam_min, lam_max]; the
    step solves (H + lam D) x = -b with D the diagonal of H (and 1e-8 more
    on a pose's, 1e-8 added on an inverse depth's). Returns the best state
    (R, t, rho). `dtype` is the arithmetic; with `storage`, the data and
    the parameters are rounded to it (the lower-precision control)."""
    if storage is not None:
        prob = {k: (v.to(storage).to(dtype) if torch.is_tensor(v) and v.is_floating_point() else v)
                for k, v in prob.items()}
    start = _state(prob, dtype)
    if storage is not None:
        start = tuple(a.to(storage).to(dtype) for a in start)
    cols, n, pts = _columns(prob)
    if n == 0:
        return start
    n_pose = 6 * int(prob["pose_free"].sum())
    best, best_cost, trial, lam, sys = start, float("inf"), start, lam0, None
    for it in range(n_iters + 1):
        c = cost(prob, trial, dtype)
        finite = math.isfinite(c) and all(bool(torch.isfinite(a).all()) for a in trial)
        if c < best_cost and finite:
            best, best_cost = trial, c
            sys = _system(prob, best, cols, n, dtype)
            lam = lam * lam_down
        else:
            lam = lam * lam_up
        lam = min(max(lam, lam_min), lam_max)
        if it == n_iters or sys is None:
            break
        H, b = sys
        diag = torch.diagonal(H)
        damp = torch.cat([(lam + 1e-8) * torch.where(diag[:n_pose] > 1e-12, diag[:n_pose],
                                                     torch.ones_like(diag[:n_pose])),
                          lam * diag[n_pose:] + 1e-8])
        L, info = torch.linalg.cholesky_ex(H + torch.diag(damp))
        if int(info) != 0:
            trial = tuple(torch.full_like(a, float("nan")) for a in best)
            continue
        delta = torch.cholesky_solve(-b[:, None], L)[:, 0]
        trial = _apply(prob, best, delta, pts, storage)
    return best


def gap(prob: dict, got: tuple, ref: tuple) -> tuple:
    """(C_got - C_ref) / (C_0 - C_ref), in float64, for states (R, t, rho):
    the share of the decrease from the problem's start to the reference's
    optimum that the solution `got` leaves; and that decrease as a share of
    C_0. A solver that returns its start reads 1, one that reaches the
    optimum 0."""
    c0 = cost(prob, _state(prob, torch.float64))
    cr = cost(prob, ref)
    cg = cost(prob, got)
    return (cg - cr) / (c0 - cr) if c0 > cr else float("nan"), (c0 - cr) / max(c0, 1e-300)
