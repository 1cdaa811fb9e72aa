"""Batched LM bundle adjustment with Schur elimination — scene family.

Port of textslam_tpu/solver/ba.py for the scene-only slice: reprojection
residuals of inverse-depth points with analytic manifold Jacobians, dense
camera system + per-point blocks, Schur complement over the points, and a
damped LM loop with deferred accept (one build per iteration). The text
residual family (photometric rows on the region-sampler kernel, with the
text planes theta as a third parameter block) arrives with the second slice;
ba_problem_from_numpy refuses a problem carrying text.

PyTorch specifics:
- The camera assembly reduces per-(target, host) pair with `index_add_`.
  The JAX package's one-hot matmul exists because TPU scatters serialize;
  on CUDA the segment-sum semantics are a plain scatter-add.
- `torch.linalg.cholesky` raises on a non-positive-definite matrix where
  jnp.linalg.cholesky returns NaN; `cholesky_ex` with a NaN factor on
  failure keeps the JAX accept/reject path (the trial goes non-finite and
  is rejected).
- The LM iterations are a Python loop (lax.scan in JAX); accept/reject stays
  on the device through torch.where, so the loop never synchronises.
- All float state is float32; TF32 is off (textslam_tpu_torch/__init__.py).
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from ..geometry import se3
from ..geometry.camera import project, project_jacobian
from ..geometry.quaternion import qto_matrix
from ..geometry.sim3 import skew

# cost charged to a residual that is nominally valid but currently broken
# (behind camera / negative depth)
BROKEN_PENALTY = 1.0e4


class SceneObs(NamedTuple):
    """Padded scene-point reprojection observations (2-dim residuals)."""

    tgt: torch.Tensor  # [O] int64 window slot of the observing KF
    host: torch.Tensor  # [O] int64 window slot of host KF, or K (dump) if frozen
    host_frozen_pose: torch.Tensor  # [O, 7] host pose snapshot if not in window
    host_in_window: torch.Tensor  # [O] bool
    point: torch.Tensor  # [O] int64 index into rho [P]
    ray: torch.Tensor  # [O, 3] host unit-plane ray
    uv: torch.Tensor  # [O, 2] observed pixel (level-0 coords)
    weight: torch.Tensor  # [O] residual weight (1/sigma_px)
    valid: torch.Tensor  # [O] bool


class BAProblem(NamedTuple):
    poses: torch.Tensor  # [K, 7] window KF poses (Tcw)
    pose_free: torch.Tensor  # [K] bool
    rho: torch.Tensor  # [P] inverse depths
    rho_free: torch.Tensor  # [P] bool
    scene: SceneObs
    fx: float = 1.0
    fy: float = 1.0
    cx: float = 0.0
    cy: float = 0.0


class LMState(NamedTuple):
    poses: torch.Tensor
    rho: torch.Tensor
    lam: torch.Tensor
    cost: torch.Tensor


def _as_dict(x) -> dict:
    return dict(x._asdict()) if hasattr(x, "_asdict") else dict(x)


def ba_problem_from_numpy(arrays: Mapping, device="cpu") -> BAProblem:
    """Build a port BAProblem from a JAX BAProblem after np.asarray on every
    field (a NamedTuple or dict; `scene` nested the same way). Float fields
    become float32, index fields int64, masks bool; the text-plane fields
    (theta) are not used by the scene family and are dropped."""
    a = _as_dict(arrays)
    if a.get("text") is not None:
        raise NotImplementedError("text residuals are not ported yet")

    def f32(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=device)

    def i64(x):
        return torch.tensor(np.asarray(x), dtype=torch.int64, device=device)

    def bool_(x):
        return torch.tensor(np.asarray(x), dtype=torch.bool, device=device)

    s = _as_dict(a["scene"])
    scene = SceneObs(
        tgt=i64(s["tgt"]), host=i64(s["host"]),
        host_frozen_pose=f32(s["host_frozen_pose"]),
        host_in_window=bool_(s["host_in_window"]), point=i64(s["point"]),
        ray=f32(s["ray"]), uv=f32(s["uv"]), weight=f32(s["weight"]),
        valid=bool_(s["valid"]),
    )
    return BAProblem(
        poses=f32(a["poses"]), pose_free=bool_(a["pose_free"]),
        rho=f32(a["rho"]), rho_free=bool_(a["rho_free"]),
        scene=scene,
        fx=float(a["fx"]), fy=float(a["fy"]), cx=float(a["cx"]), cy=float(a["cy"]),
    )


def _poses_ext(problem: BAProblem) -> torch.Tensor:
    """Window poses + the identity dump slot K for frozen hosts."""
    return torch.cat([problem.poses, se3.identity((1,), device=problem.poses.device)], dim=0)


def _gather_pose(poses_ext: torch.Tensor, slot, frozen_pose, in_window):
    """Current pose of a block: window pose if in window else frozen snapshot."""
    return torch.where(in_window, poses_ext[slot], frozen_pose)


def _scene_residual(delta_tgt, delta_host, drho, obs_ray, obs_uv, tgt_pose, host_pose, rho, fx, fy, cx, cy):
    """2-dim reprojection residual at local tangents (batched over rows):
    p_host = ray/rho; p_c = Tcw ∘ Trw^-1 p_host; r = K(p_c) - uv."""
    T_t = se3.retract(tgt_pose, delta_tgt)
    T_h = se3.retract(host_pose, delta_host)
    p_h = obs_ray / (rho + drho)[:, None]
    p_c = se3.apply(se3.compose(T_t, se3.inverse(T_h)), p_h)
    return project(p_c, fx, fy, cx, cy) - obs_uv, p_c[:, 2]


def _huber_w(r2: torch.Tensor, delta: float) -> torch.Tensor:
    """sqrt-IRLS Huber weight for squared norm r2 and threshold delta."""
    rn = torch.sqrt(r2.clamp(min=1e-12))
    return torch.where(rn <= delta, torch.ones_like(rn), torch.sqrt(delta / rn))


def _robust_cost(r2: torch.Tensor, huber: float, ok, valid) -> torch.Tensor:
    rn = torch.sqrt(r2.clamp(min=1e-12))
    cost = torch.where(rn <= huber, r2, 2 * huber * rn - huber * huber)
    broken = torch.where(valid, torch.full_like(cost, BROKEN_PENALTY), torch.zeros_like(cost))
    return torch.where(ok, cost, broken)


def scene_terms(problem: BAProblem, huber: float):
    """Residuals + analytic tangent Jacobians for all scene observations.

    r = w(K(A p_h) - uv), A = T_t ∘ T_h⁻¹, p_h = ray/ρ, with
        dp_c/dδ_tgt  = [-[p_c - t_t]ₓ | I]
        dp_c/dδ_host = [ R_A [p_h - t_h]ₓ | -R_A ]
        dp_c/dρ      = -R_A p_h / ρ
    Returns dict with r [O,2], J_t [O,2,6], J_h [O,2,6], J_l [O,2,1],
    w [O] (validity x huber), cost [O] (robust, squared), chi2 [O]."""
    s = problem.scene
    poses_ext = _poses_ext(problem)
    tgt_pose = poses_ext[s.tgt]
    host_pose = _gather_pose(poses_ext, s.host, s.host_frozen_pose, s.host_in_window[:, None])
    rho = problem.rho[s.point]

    A = se3.compose(tgt_pose, se3.inverse(host_pose))  # [O, 7]
    R_A = qto_matrix(A[:, :4])  # [O, 3, 3]
    p_h = s.ray / rho[:, None]
    p_c = se3.apply(A, p_h)
    r = project(p_c, problem.fx, problem.fy, problem.cx, problem.cy) - s.uv
    z = p_c[:, 2]

    Juv = project_jacobian(p_c, problem.fx, problem.fy)  # [O, 2, 3]
    J_t = torch.cat([Juv @ -skew(p_c - tgt_pose[:, 4:7]), Juv], dim=-1)  # [O, 2, 6]
    JuvRA = Juv @ R_A
    J_h = torch.cat([Juv @ (R_A @ skew(p_h - host_pose[:, 4:7])), -JuvRA], dim=-1)
    J_l = JuvRA @ (-p_h / rho[:, None])[..., None]  # [O, 2, 1]

    wgt = s.weight[:, None]
    r = r * wgt
    J_t = J_t * wgt[..., None]
    J_h = J_h * wgt[..., None]
    J_l = J_l * wgt[..., None]
    ok = s.valid & (z > 1e-4) & (rho > 1e-6)
    r2 = (r * r).sum(-1)
    w = torch.where(ok, _huber_w(r2, huber), torch.zeros_like(r2))
    cost = _robust_cost(r2, huber, ok, s.valid)
    # hard-zero invalid rows: padded/degenerate entries can carry NaN
    # Jacobians and 0*NaN = NaN would poison the scatter-adds
    okm = ok[:, None]
    r = torch.where(okm, r, 0.0)
    J_t = torch.where(okm[..., None], J_t, 0.0)
    J_h = torch.where(okm[..., None], J_h, 0.0)
    J_l = torch.where(okm[..., None], J_l, 0.0)
    # zero Jacobians of frozen landmark / frozen host blocks
    J_l = J_l * problem.rho_free[s.point][:, None, None]
    J_h = J_h * s.host_in_window[:, None, None]
    return {"r": r, "J_t": J_t, "J_h": J_h, "J_l": J_l, "w": w, "cost": cost, "chi2": r2}


def scene_cost(problem: BAProblem, huber: float) -> torch.Tensor:
    """Residual-only robust cost (no Jacobians), evaluated through the
    zero-tangent retraction exactly as the JAX version."""
    s = problem.scene
    poses_ext = _poses_ext(problem)
    tgt_pose = poses_ext[s.tgt]
    host_pose = _gather_pose(poses_ext, s.host, s.host_frozen_pose, s.host_in_window[:, None])
    rho = problem.rho[s.point]
    zeros6 = torch.zeros_like(tgt_pose[:, :6])
    r, z = _scene_residual(zeros6, zeros6, torch.zeros_like(rho), s.ray, s.uv, tgt_pose,
                           host_pose, rho, problem.fx, problem.fy, problem.cx, problem.cy)
    r = r * s.weight[:, None]
    ok = s.valid & (z > 1e-4) & (rho > 1e-6)
    return _robust_cost((r * r).sum(-1), huber, ok, s.valid).sum()


def _pose_indices(slot: torch.Tensor) -> torch.Tensor:
    """Row indices [O, 6] of a pose block in the extended [6(K+1)] system."""
    return slot[:, None] * 6 + torch.arange(6, device=slot.device)[None, :]


def assemble_camera_system(terms, tgt, host, K: int):
    """Camera-side normal equations (Hcc [6K+6, 6K+6], bc [6K+6]).

    Per-row 12x12 blocks reduce per (target, host) pair by index_add_ (the
    segment-sum semantics of the JAX version), then the four 6x6 quadrants
    are placed with dense reshapes/transposes."""
    J = torch.cat([terms["J_t"], terms["J_h"]], dim=-1)  # [O, R, 12]
    Jw = J * terms["w"][:, None, None]
    H_blocks = Jw.transpose(1, 2) @ J  # [O, 12, 12]
    b_blocks = (Jw * terms["r"][..., None]).sum(1)  # [O, 12]

    Kp = K + 1
    pair = tgt * Kp + host  # [O]
    Hp = H_blocks.new_zeros((Kp * Kp, 12, 12)).index_add_(0, pair, H_blocks).reshape(Kp, Kp, 12, 12)
    bp = b_blocks.new_zeros((Kp * Kp, 12)).index_add_(0, pair, b_blocks).reshape(Kp, Kp, 12)

    n = 6 * Kp
    # off-diagonal quadrants placed at (tgt, host) and (host, tgt)
    M_th = Hp[:, :, 0:6, 6:12].permute(0, 2, 1, 3).reshape(n, n)
    M_ht = Hp[:, :, 6:12, 0:6].permute(1, 2, 0, 3).reshape(n, n)
    # diagonal blocks: sum the tt quadrant over hosts and hh over targets
    D = Hp[:, :, 0:6, 0:6].sum(1) + Hp[:, :, 6:12, 6:12].sum(0)
    Hcc = (M_th + M_ht).reshape(Kp, 6, Kp, 6)
    ar = torch.arange(Kp, device=Hcc.device)
    Hcc[ar, :, ar, :] += D
    bc = (bp[:, :, 0:6].sum(1) + bp[:, :, 6:12].sum(0)).reshape(n)
    return Hcc.reshape(n, n), bc


def assemble_landmark_system(terms, tgt, host, lm_idx, n_landmarks: int, K: int, lm_dim: int):
    """Per-landmark blocks: W [L, 6K+6, D], Hll [L, D, D], bl [L, D], by
    index_add_ over the landmark index."""
    J = torch.cat([terms["J_t"], terms["J_h"]], dim=-1)  # [O, R, 12]
    Jl = terms["J_l"]  # [O, R, D]
    w = terms["w"][:, None, None]
    Jlw = Jl * w
    Hll_o = Jlw.transpose(1, 2) @ Jl  # [O, D, D]
    bl_o = (Jlw * terms["r"][..., None]).sum(1)  # [O, D]
    Hll = Hll_o.new_zeros((n_landmarks, lm_dim, lm_dim)).index_add_(0, lm_idx, Hll_o)
    bl = bl_o.new_zeros((n_landmarks, lm_dim)).index_add_(0, lm_idx, bl_o)
    n = 6 * (K + 1)
    W_o = (J * w).transpose(1, 2) @ Jl  # [O, 12, D]
    idx = torch.cat([_pose_indices(tgt), _pose_indices(host)], dim=-1)  # [O, 12]
    flat = (lm_idx[:, None] * n + idx).reshape(-1)
    W = W_o.new_zeros((n_landmarks * n, lm_dim)).index_add_(0, flat, W_o.reshape(-1, lm_dim))
    return W.reshape(n_landmarks, n, lm_dim), Hll, bl


def _apply_update(problem: BAProblem, delta_c, delta_rho):
    K = problem.poses.shape[0]
    d = delta_c[: 6 * K].reshape(K, 6) * problem.pose_free[:, None]
    poses = torch.where(problem.pose_free[:, None], se3.retract(problem.poses, d), problem.poses)
    return poses, problem.rho + delta_rho * problem.rho_free


def solve_ba(
    problem: BAProblem,
    n_iters: int = 10,
    huber_scene: float = 2.447,
    lam0: float = 1e-4,
    lam_up: float = 10.0,
    lam_down: float = 0.1,
    lam_min: float = 1e-12,
    lam_max: float = 1e8,
) -> LMState:
    """Damped LM with a fixed iteration count and accept/reject inside
    (Ceres TRUST_REGION/LM semantics; the reference runs `its` iterations
    per pyramid level with Huber losses and fixed blocks). The JAX
    version's no-free-poses shortcut (loop-time landmark passes) arrives
    with loop closing."""
    return _solve_ba_body(problem, n_iters, huber_scene, lam0, lam_up, lam_down,
                          lam_min=lam_min, lam_max=lam_max)


def _solve_ba_body(problem, n_iters, huber_scene, lam0, lam_up, lam_down,
                   lam_min=1e-12, lam_max=1e8):
    K = problem.poses.shape[0]
    P = problem.rho.shape[0]
    n = 6 * (K + 1)
    dev = problem.poses.device
    free_mask = torch.cat([problem.pose_free.repeat_interleave(6),
                           torch.zeros(6, dtype=torch.bool, device=dev)])
    eye = torch.eye(n, device=dev)

    def build(prob):
        """(Hcc, bc, Wr, Hr, br), cost at the parameters of `prob`."""
        ts = scene_terms(prob, huber_scene)
        Hcc, bc = assemble_camera_system(ts, prob.scene.tgt, prob.scene.host, K)
        Wr, Hr, br = assemble_landmark_system(
            ts, prob.scene.tgt, prob.scene.host, prob.scene.point, P, K, 1)
        return (Hcc, bc, Wr, Hr, br), ts["cost"].sum()

    def solve_from(sys, lam):
        """The damped step from an assembled system."""
        Hcc, bc, Wr, Hr, br = sys
        Hr_d = Hr[:, 0, 0] * (1.0 + lam) + 1e-8
        Hr_inv = torch.where(Hr[:, 0, 0] > 1e-12, 1.0 / Hr_d, torch.zeros_like(Hr_d))
        W2 = Wr[:, :, 0]  # [P, n]
        WHinv = W2 * Hr_inv[:, None]
        H_red = Hcc - WHinv.T @ W2
        b_red = bc - WHinv.T @ br[:, 0]

        diag = torch.diagonal(H_red)
        diag_safe = torch.where(free_mask & (diag > 1e-12), diag, torch.ones_like(diag))
        Dinv = 1.0 / torch.sqrt(diag_safe)
        Hs = H_red * Dinv[:, None] * Dinv[None, :]
        Hs = torch.where(free_mask[:, None] & free_mask[None, :], Hs, 0.0)
        Hs = Hs + (lam + 1e-8) * eye + torch.diag((~free_mask).float())
        bs = torch.where(free_mask, b_red * Dinv, 0.0)
        L, info = torch.linalg.cholesky_ex(Hs)
        L = torch.where(info == 0, L, float("nan"))  # jnp.linalg.cholesky semantics
        delta_s = torch.cholesky_solve(-bs[:, None], L)[:, 0]
        delta_c = delta_s * Dinv * free_mask
        drho = Hr_inv * (-br[:, 0] - W2 @ delta_c)
        return delta_c, drho

    # deferred-accept LM: ONE build per iteration. The trial's build gives
    # its cost (accept/reject against the best) and, on accept, the next
    # linearization; on reject the best system is retried with more damping
    best = (problem.poses, problem.rho)
    best_cost = torch.tensor(float("inf"), device=dev)
    best_sys = None
    trial = best
    lam = torch.tensor(lam0, dtype=torch.float32, device=dev)
    for it in range(n_iters + 1):
        sys_t, cost_t = build(problem._replace(poses=trial[0], rho=trial[1]))
        if best_sys is None:  # the first build always wins unless non-finite
            best_sys = tuple(torch.zeros_like(a) for a in sys_t)
        finite = (torch.isfinite(cost_t) & torch.isfinite(trial[0]).all()
                  & torch.isfinite(trial[1]).all())
        accept = (cost_t < best_cost) & finite
        best = tuple(torch.where(accept, a, b) for a, b in zip(trial, best))
        best_cost = torch.where(accept, cost_t, best_cost)
        best_sys = tuple(torch.where(accept, a, b) for a, b in zip(sys_t, best_sys))
        lam = torch.where(accept, lam * lam_down, lam * lam_up).clamp(lam_min, lam_max)
        if it == n_iters:
            break  # the JAX scan's last step computes a trial nobody reads
        delta_c, drho = solve_from(best_sys, lam)
        trial = _apply_update(problem._replace(poses=best[0], rho=best[1]), delta_c, drho)
    return LMState(poses=best[0], rho=best[1], lam=lam, cost=best_cost)


def scene_chi2(problem: BAProblem, huber: float):
    """Post-solve per-observation chi2 for outlier gating."""
    ts = scene_terms(problem, huber)
    return ts["chi2"], ts["w"] > 0
