"""Batched LM bundle adjustment with Schur elimination, port of
textslam_tpu/solver/ba.py: scene reprojection rows of inverse-depth points
and 8-sample photometric text rows of planar text objects (theta), with
analytic manifold Jacobians, a dense camera system + per-landmark blocks,
Schur complement over rho and theta, and a damped LM loop with deferred
accept (one build per iteration).

The text rows sample (intensity, sobel-x, sobel-y) from the target image
stack through the grouped region sampler (ops.patch_sample, a CUDA kernel
on the GPU) whenever the rows arrive grouped by (object, target) pair; see
_sample_text_values.

PyTorch specifics:
- The camera assembly reduces per-(target, host) pair, and the landmark
  assembly per landmark, with `index_add_` (_segment_sum). The JAX
  package's one-hot matmul exists because TPU scatters serialize; on CUDA
  the segment-sum semantics are a scatter-add, taken in PyTorch's
  deterministic mode so that a run is reproducible, as the JAX one is.
- `torch.linalg.cholesky` raises on a non-positive-definite matrix where
  jnp.linalg.cholesky returns NaN; `cholesky_ex` with a NaN factor on
  failure keeps the JAX accept/reject path (the trial goes non-finite and
  is rejected).
- The LM iterations are a Python loop (lax.scan in JAX); accept/reject stays
  on the device through torch.where, so the loop never synchronises.
- All float state is float32; TF32 is off (textslam_tpu_torch/__init__.py),
  which is the JAX solver's default_matmul_precision("highest").
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from ..geometry import se3
from ..geometry.camera import project, project_jacobian
from ..geometry.quaternion import qto_matrix
from ..geometry.sim3 import skew
from ..ops import interp, patch_sample

# cost charged to a residual that is nominally valid but currently broken
# (behind camera / negative depth / sampled off-image)
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


class TextObs(NamedTuple):
    """Padded text photometric observations (8-dim residuals, one per text
    feature at one pyramid level; the INTERVAL8 pattern rays are stored)."""

    tgt: torch.Tensor  # [O] int64 window slot of the observing KF
    host: torch.Tensor  # [O] int64 window slot of host KF, or K if frozen
    host_frozen_pose: torch.Tensor  # [O, 7]
    host_in_window: torch.Tensor  # [O] bool
    text: torch.Tensor  # [O] int64 index into theta [T]
    rays: torch.Tensor  # [O, 8, 3] pattern rays in the host frame
    ref_inten: torch.Tensor  # [O, 8] reference normalized intensities
    mu_sigma: torch.Tensor  # [O, 2] target-frame (mu, sigma) at this level
    weight: torch.Tensor  # [O]
    valid: torch.Tensor  # [O] bool
    level: int = 0  # pyramid level of this batch


class BAProblem(NamedTuple):
    poses: torch.Tensor  # [K, 7] window KF poses (Tcw)
    pose_free: torch.Tensor  # [K] bool
    rho: torch.Tensor  # [P] inverse depths
    rho_free: torch.Tensor  # [P] bool
    scene: Optional[SceneObs] = None
    theta: Optional[torch.Tensor] = None  # [T, 3] text planes
    theta_free: Optional[torch.Tensor] = None  # [T] bool
    text: Optional[TextObs] = None
    images: Optional[torch.Tensor] = None  # [K, H_l, W_l, 3] target level images
    fx: float = 1.0
    fy: float = 1.0
    cx: float = 0.0
    cy: float = 0.0


class LMState(NamedTuple):
    poses: torch.Tensor
    rho: torch.Tensor
    theta: Optional[torch.Tensor]
    lam: torch.Tensor
    cost: torch.Tensor


def _as_dict(x) -> dict:
    return dict(x._asdict()) if hasattr(x, "_asdict") else dict(x)


def ba_problem_from_numpy(arrays: Mapping, *, device) -> BAProblem:
    """Build a port BAProblem on `device` from a JAX BAProblem after
    np.asarray on every field (a NamedTuple or dict; `scene` and `text`
    nested the same way, either may be None). Float fields become float32,
    index fields int64, masks bool."""
    a = _as_dict(arrays)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ba_problem_from_numpy(device='cuda') needs a CUDA GPU and none is available")

    def f32(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)

    def i64(x):
        return torch.tensor(np.asarray(x), dtype=torch.int64, device=dev)

    def bool_(x):
        return torch.tensor(np.asarray(x), dtype=torch.bool, device=dev)

    scene = text = None
    if a.get("scene") is not None:
        s = _as_dict(a["scene"])
        scene = SceneObs(
            tgt=i64(s["tgt"]), host=i64(s["host"]),
            host_frozen_pose=f32(s["host_frozen_pose"]),
            host_in_window=bool_(s["host_in_window"]), point=i64(s["point"]),
            ray=f32(s["ray"]), uv=f32(s["uv"]), weight=f32(s["weight"]),
            valid=bool_(s["valid"]),
        )
    if a.get("text") is not None:
        t = _as_dict(a["text"])
        text = TextObs(
            tgt=i64(t["tgt"]), host=i64(t["host"]),
            host_frozen_pose=f32(t["host_frozen_pose"]),
            host_in_window=bool_(t["host_in_window"]), text=i64(t["text"]),
            rays=f32(t["rays"]), ref_inten=f32(t["ref_inten"]),
            mu_sigma=f32(t["mu_sigma"]), weight=f32(t["weight"]),
            valid=bool_(t["valid"]), level=int(t.get("level", 0)),
        )
    theta = a.get("theta")
    return BAProblem(
        poses=f32(a["poses"]), pose_free=bool_(a["pose_free"]),
        rho=f32(a["rho"]), rho_free=bool_(a["rho_free"]),
        scene=scene,
        theta=None if theta is None else f32(theta),
        theta_free=None if theta is None else bool_(a["theta_free"]),
        text=text,
        images=None if a.get("images") is None else f32(a["images"]),
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


def _segment_sum(src: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """out [n, ...] with out[i] the sum of the rows src[j] with idx[j] == i.

    On CUDA, index_add_ accumulates with atomics by default: the order of
    the float32 additions, and with it the rounding, changes from run to
    run, and the LM's accept/reject decisions and the map follow it. In
    PyTorch's deterministic mode index_add_ sorts the indices and sums each
    segment in a fixed order, so the mode is switched on for this call. The
    CPU sums in order anyway."""
    out = src.new_zeros((n,) + src.shape[1:])
    if not src.is_cuda:
        return out.index_add_(0, idx, src)
    mode = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return out.index_add_(0, idx, src)
    finally:
        torch.use_deterministic_algorithms(mode, warn_only=warn_only)


def assemble_camera_system(terms, tgt, host, K: int):
    """Camera-side normal equations (Hcc [6K+6, 6K+6], bc [6K+6]).

    Per-row 12x12 blocks reduce per (target, host) pair by _segment_sum
    (the segment-sum semantics of the JAX version), then the four 6x6 quadrants
    are placed with dense reshapes/transposes."""
    J = torch.cat([terms["J_t"], terms["J_h"]], dim=-1)  # [O, R, 12]
    Jw = J * terms["w"][:, None, None]
    H_blocks = Jw.transpose(1, 2) @ J  # [O, 12, 12]
    b_blocks = (Jw * terms["r"][..., None]).sum(1)  # [O, 12]

    Kp = K + 1
    pair = tgt * Kp + host  # [O]
    Hp = _segment_sum(H_blocks, pair, Kp * Kp).reshape(Kp, Kp, 12, 12)
    bp = _segment_sum(b_blocks, pair, Kp * Kp).reshape(Kp, Kp, 12)

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


def assemble_landmark_system(terms, tgt, host, lm_idx, n_landmarks: int, K: int, lm_dim: int,
                             with_coupling: bool = True):
    """Per-landmark blocks: W [L, 6K+6, D], Hll [L, D, D], bl [L, D], by
    _segment_sum over the landmark index. with_coupling=False skips W (a
    zero placeholder) for problems whose poses are all fixed."""
    J = torch.cat([terms["J_t"], terms["J_h"]], dim=-1)  # [O, R, 12]
    Jl = terms["J_l"]  # [O, R, D]
    w = terms["w"][:, None, None]
    Jlw = Jl * w
    Hll_o = Jlw.transpose(1, 2) @ Jl  # [O, D, D]
    bl_o = (Jlw * terms["r"][..., None]).sum(1)  # [O, D]
    Hll = _segment_sum(Hll_o, lm_idx, n_landmarks)
    bl = _segment_sum(bl_o, lm_idx, n_landmarks)
    if not with_coupling:
        return Hll.new_zeros(1), Hll, bl
    n = 6 * (K + 1)
    W_o = (J * w).transpose(1, 2) @ Jl  # [O, 12, D]
    idx = torch.cat([_pose_indices(tgt), _pose_indices(host)], dim=-1)  # [O, 12]
    flat = (lm_idx[:, None] * n + idx).reshape(-1)
    W = _segment_sum(W_o.reshape(-1, lm_dim), flat, n_landmarks * n)
    return W.reshape(n_landmarks, n, lm_dim), Hll, bl


# ---------------------------------------------------------------------------
# text family
# ---------------------------------------------------------------------------


def _sample_text_values(images: torch.Tensor, tgt: torch.Tensor, uv: torch.Tensor,
                        pair_feat: int):
    """Sample (I, sobel_x, sobel_y) at the text pattern positions uv [O, S, 2].

    pair_feat > 0 declares that rows arrive grouped in [pair, pair_feat]
    order, one group per (text object, target KF) pair. Then the grouped
    region sampler runs on every device (the TPU path of the JAX package):
    its kernel on the GPU, its plain version on the CPU. Its mask differs
    from the per-feature patch path (the JAX package's CPU path) only where
    a box outgrows the region window; text_region_coverage counts that.
    Returns (vals [O, S, 3], mask [O, S])."""
    O, S = uv.shape[0], uv.shape[1]
    if pair_feat > 0 and O % pair_feat == 0:
        G = O // pair_feat
        vals, mask = patch_sample.grouped_bilinear_stack(
            images, tgt.reshape(G, pair_feat)[:, 0], uv.reshape(G, pair_feat * S, 2))
        return vals.reshape(O, S, -1), mask.reshape(O, S)
    return interp.patch_bilinear_stack(images, tgt, uv[:, 0], uv)


def inv3x3_spd(A: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched symmetric 3x3 blocks (adjugate/det).
    Blocks with |det| <= 1e-10 return 0 (an unobserved landmark)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e = A[..., 1, 1], A[..., 1, 2]
    f = A[..., 2, 2]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    ok = det.abs() > 1e-10
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    adj = torch.stack([co00, co01, co02, co01, co11, co12, co02, co12, co22], dim=-1)
    return adj.reshape(A.shape[:-2] + (3, 3)) * inv_det[..., None, None]


def _text_level_K(problem: BAProblem, level: int):
    """Level-l intrinsics of the x2 direct pyramid."""
    sc = 2.0 ** level
    return problem.fx / sc, problem.fy / sc, problem.cx / sc, problem.cy / sc


def _text_projection(problem: BAProblem):
    """Pattern rays through the planes into the targets, at the level of the
    batch: (tgt_pose [O,7], host_pose [O,7], A [O,7], rho [O,8],
    p_h [O,8,3], p_c [O,8,3], uv [O,8,2], level intrinsics)."""
    t = problem.text
    poses_ext = _poses_ext(problem)
    tgt_pose = poses_ext[t.tgt]
    host_pose = _gather_pose(poses_ext, t.host, t.host_frozen_pose, t.host_in_window[:, None])
    theta = problem.theta[t.text]
    Kl = _text_level_K(problem, t.level)
    A = se3.compose(tgt_pose, se3.inverse(host_pose))  # [O, 7]
    rho = -(t.rays * theta[:, None, :]).sum(-1)  # [O, 8]
    p_h = t.rays / rho[..., None]
    p_c = se3.apply(A[:, None, :], p_h)  # [O, 8, 3]
    return tgt_pose, host_pose, A, rho, p_h, p_c, project(p_c, *Kl), Kl


def text_terms(problem: BAProblem, huber: float, pair_feat: int = 0):
    """Residuals + analytic tangent Jacobians for text observations at one
    pyramid level.

    r_k = w((I_l(u_k) - mu)/sigma - ref_k), u_k = K_l(A m_k / rho_k),
    rho_k = -m_k^T theta, A = T_t o T_h^-1, with image gradients from the
    Sobel channels (dI/dx = sobel/8):
        dp_c/d(delta_tgt)  = [-[p_c - t_t]x | I]
        dp_c/d(delta_host) = [ R_A [p_h - t_h]x | -R_A ]
        dp_c/d(theta)      = R_A (m m^T) / rho^2
    problem.images must be [K, H_l, W_l, 3] = (I, sobel_x, sobel_y)."""
    t = problem.text
    tgt_pose, host_pose, A, rho, p_h, p_c, uv, (fxl, fyl, _, _) = _text_projection(problem)
    R_A = qto_matrix(A[:, :4])  # [O, 3, 3]
    vals, mask = _sample_text_values(problem.images, t.tgt, uv, pair_feat)
    I = vals[..., 0]
    g = vals[..., 1:3] / 8.0  # sobel -> dI/dpx
    mu = t.mu_sigma[:, 0:1]
    sigma = t.mu_sigma[:, 1:2]
    r = (I - mu) / sigma - t.ref_inten
    sample_ok = mask & (p_c[..., 2] > 1e-4) & (rho > 1e-6)

    Juv = project_jacobian(p_c, fxl, fyl)  # [O, 8, 2, 3]
    Jpix = ((g / sigma[..., None])[..., None, :] @ Juv)[..., 0, :]  # [O, 8, 3]
    J_t = torch.cat([(Jpix[..., None, :] @ -skew(p_c - tgt_pose[:, None, 4:7]))[..., 0, :],
                     Jpix], dim=-1)  # [O, 8, 6]
    JpixR = Jpix @ R_A  # [O, 8, 3]
    J_h = torch.cat([(JpixR[..., None, :] @ skew(p_h - host_pose[:, None, 4:7]))[..., 0, :],
                     -JpixR], dim=-1)
    a = (JpixR * t.rays).sum(-1)  # [O, 8]
    J_l = a[..., None] * t.rays / (rho * rho)[..., None]  # [O, 8, 3]

    w_row = t.weight[:, None] * sample_ok
    r = r * w_row
    J_t = J_t * w_row[..., None]
    J_h = J_h * w_row[..., None]
    J_l = J_l * w_row[..., None]
    ok = t.valid & (sample_ok.sum(-1) >= 4)
    r2 = (r * r).sum(-1)
    w = torch.where(ok, _huber_w(r2, huber), torch.zeros_like(r2))
    cost = _robust_cost(r2, huber, ok, t.valid)
    okm = ok[:, None]
    r = torch.where(okm, r, 0.0)
    J_t = torch.where(okm[..., None], J_t, 0.0)
    J_h = torch.where(okm[..., None], J_h, 0.0)
    J_l = torch.where(okm[..., None], J_l, 0.0)
    J_l = J_l * problem.theta_free[t.text][:, None, None]
    J_h = J_h * t.host_in_window[:, None, None]
    return {"r": r, "J_t": J_t, "J_h": J_h, "J_l": J_l, "w": w, "cost": cost, "chi2": r2}


def text_chi2(problem: BAProblem, huber: float, pair_feat: int = 0):
    tt = text_terms(problem, huber, pair_feat)
    return tt["chi2"], tt["w"] > 0


def text_sample_errors(problem: BAProblem, pair_feat: int = 0):
    """Per-sample |(I - mu)/sigma - ref| and validity for the text batch:
    the unweighted normalized-intensity errors the post-solve per-feature
    gate compares against chi2Text[level]. Returns (|err| [O, 8], ok [O, 8])."""
    t = problem.text
    *_, rho, _, p_c, uv, _ = _text_projection(problem)
    vals, mask = _sample_text_values(problem.images, t.tgt, uv, pair_feat)
    r = (vals[..., 0] - t.mu_sigma[:, 0:1]) / t.mu_sigma[:, 1:2] - t.ref_inten
    sample_ok = mask & (p_c[..., 2] > 1e-4) & (rho > 1e-6) & t.valid[:, None]
    return torch.where(sample_ok, r, 0.0).abs(), sample_ok


def text_region_coverage(problem: BAProblem, pair_feat: int):
    """Samples the grouped region window drops against the per-feature
    patch gather: (n_dropped, n_in_image). Nonzero only for projected boxes
    larger than the region."""
    t = problem.text
    *_, rho, _, p_c, uv, _ = _text_projection(problem)
    _, mask_grouped = _sample_text_values(problem.images, t.tgt, uv, pair_feat)
    _, mask_exact = interp.patch_bilinear_stack(problem.images, t.tgt, uv[:, 0], uv)
    live = t.valid[:, None] & (p_c[..., 2] > 1e-4) & (rho > 1e-6)
    dropped = (mask_exact & ~mask_grouped & live).sum()
    return int(dropped), int((mask_exact & live).sum())


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------


def rho_inv(Hr: torch.Tensor, lam) -> torch.Tensor:
    """The damped inverse of the 1x1 point blocks Hr [P, 1, 1]; 0 for an
    unobserved point."""
    Hr_d = Hr[:, 0, 0] * (1.0 + lam) + 1e-8
    return torch.where(Hr[:, 0, 0] > 1e-12, 1.0 / Hr_d, torch.zeros_like(Hr_d))


def theta_inv(Ht: torch.Tensor, lam) -> torch.Tensor:
    """The damped inverse of the 3x3 text blocks Ht [T, 3, 3]:
    H + diag(lam * diag(H) + 1e-8), the JAX solver's damping shape."""
    return inv3x3_spd(Ht + (lam * Ht + 1e-8) * torch.eye(3, device=Ht.device))


def reduced_camera_solve(H_red: torch.Tensor, b_red: torch.Tensor, pose_free: torch.Tensor,
                         lam) -> torch.Tensor:
    """The camera step of the reduced (Schur) system H_red [n, n], b_red
    [n]: Jacobi-scaled, damped by lam + 1e-8 on the scaled diagonal, fixed
    poses and the 6 padding rows pinned to identity, Cholesky solve.
    Returns delta_c [n], zero on fixed poses."""
    n = H_red.shape[0]
    dev = H_red.device
    free = torch.cat([pose_free.repeat_interleave(6), torch.zeros(6, dtype=torch.bool, device=dev)])
    diag = torch.diagonal(H_red)
    Dinv = 1.0 / torch.sqrt(torch.where(free & (diag > 1e-12), diag, torch.ones_like(diag)))
    Hs = H_red * Dinv[:, None] * Dinv[None, :]
    Hs = torch.where(free[:, None] & free[None, :], Hs, 0.0)
    Hs = Hs + (lam + 1e-8) * torch.eye(n, device=dev) + torch.diag((~free).float())
    bs = torch.where(free, b_red * Dinv, 0.0)
    L, info = torch.linalg.cholesky_ex(Hs)
    L = torch.where(info == 0, L, float("nan"))  # jnp.linalg.cholesky semantics
    return torch.cholesky_solve(-bs[:, None], L)[:, 0] * Dinv * free


def damped_step(problem: BAProblem, sys, lam, no_free_poses: bool = False):
    """The damped LM step (delta_c, drho, dtheta) from an assembled system
    sys = (Hcc, bc, Wr, Hr, br, Wt, Ht, bt) (absent families as 1-element
    placeholders): the point and text blocks are eliminated by Schur
    complement, the reduced camera system solved, and the landmarks
    back-substituted. `problem` gives the families present, pose_free and
    the landmark shapes. no_free_poses: every pose block is fixed, so the
    landmark blocks decouple and each solves alone (delta_c is zero)."""
    Hcc, bc, Wr, Hr, br, Wt, Ht, bt = sys
    has_scene, has_text = problem.scene is not None, problem.text is not None
    n = 6 * (problem.poses.shape[0] + 1)
    zero_theta = None if problem.theta is None else torch.zeros_like(problem.theta)
    drho, dtheta = torch.zeros_like(problem.rho), zero_theta
    if no_free_poses:
        if has_scene:
            drho = rho_inv(Hr, lam) * (-br[:, 0])
        if has_text:
            dtheta = (theta_inv(Ht, lam) @ -bt[..., None])[..., 0]
        return torch.zeros(n, device=problem.poses.device), drho, dtheta
    H_red, b_red = Hcc, bc
    if has_scene:
        Hr_inv = rho_inv(Hr, lam)
        W2 = Wr[:, :, 0]  # [P, n]
        WHinv = W2 * Hr_inv[:, None]
        H_red = H_red - WHinv.T @ W2
        b_red = b_red - WHinv.T @ br[:, 0]
    if has_text:
        Ht_inv = theta_inv(Ht, lam)
        WtHinv = Wt @ Ht_inv  # [T, n, 3]
        H_red = H_red - torch.einsum("pid,pjd->ij", WtHinv, Wt)
        b_red = b_red - torch.einsum("pid,pd->i", WtHinv, bt)
    delta_c = reduced_camera_solve(H_red, b_red, problem.pose_free, lam)
    if has_scene:
        drho = Hr_inv * (-br[:, 0] - W2 @ delta_c)
    if has_text:
        dtheta = (Ht_inv @ (-bt - torch.einsum("pid,i->pd", Wt, delta_c))[..., None])[..., 0]
    return delta_c, drho, dtheta


def retract_poses(poses: torch.Tensor, pose_free: torch.Tensor, delta_c: torch.Tensor):
    """Poses [K, 7] moved by the camera step delta_c [6 (K + 1)] where free."""
    K = poses.shape[0]
    d = delta_c[: 6 * K].reshape(K, 6) * pose_free[:, None]
    return torch.where(pose_free[:, None], se3.retract(poses, d), poses)


def apply_update(problem: BAProblem, delta_c, delta_rho, delta_theta):
    """(poses, rho, theta) of `problem` moved by a damped_step."""
    poses = retract_poses(problem.poses, problem.pose_free, delta_c)
    rho = problem.rho + delta_rho * problem.rho_free
    theta = problem.theta
    if theta is not None:
        theta = theta + delta_theta * problem.theta_free[:, None]
    return poses, rho, theta


def solve_ba(
    problem: BAProblem,
    n_iters: int = 10,
    huber_scene: float = 2.447,
    huber_text: float = 3.0,
    lam0: float = 1e-4,
    lam_up: float = 10.0,
    lam_down: float = 0.1,
    text_pair_feat: int = 0,
    lam_min: float = 1e-12,
    lam_max: float = 1e8,
    no_free_poses: bool = False,
) -> LMState:
    """Damped LM with a fixed iteration count and accept/reject inside
    (Ceres TRUST_REGION/LM semantics: the reference runs `its` iterations per
    pyramid level with Huber losses and fixed blocks).

    no_free_poses=True declares that every pose block is fixed (the
    OptimizeLandmarker shape): the camera assembly, the pose-landmark
    coupling, the Schur complement and the Cholesky are skipped, and each
    landmark block solves alone; the camera step is identically zero."""
    return _solve_ba_body(problem, n_iters, huber_scene, huber_text, lam0, lam_up, lam_down,
                          text_pair_feat, lam_min=lam_min, lam_max=lam_max,
                          no_free_poses=no_free_poses)


def _solve_ba_body(problem, n_iters, huber_scene, huber_text, lam0, lam_up, lam_down,
                   text_pair_feat=0, lam_min=1e-12, lam_max=1e8, no_free_poses=False,
                   build_override=None):
    """The deferred-accept LM. `build_override` (parallel.ba_sharded: the
    sharded assembly, summed over the mesh) replaces the single-device
    `build` below with the same signature; the schedule, damping, Schur
    elimination and back-substitution are the same either way."""
    K = problem.poses.shape[0]
    P = problem.rho.shape[0]
    n = 6 * (K + 1)
    dev = problem.poses.device
    has_scene = problem.scene is not None
    has_text = problem.text is not None
    T = problem.theta.shape[0] if has_text else 0
    z1 = torch.zeros(1, device=dev)

    def build(prob):
        """(Hcc, bc, Wr, Hr, br, Wt, Ht, bt), cost at the parameters of
        `prob`; absent blocks are 1-element zero placeholders."""
        Hcc = torch.zeros((1, 1) if no_free_poses else (n, n), device=dev)
        bc = torch.zeros(1 if no_free_poses else n, device=dev)
        Wr = Hr = br = Wt = Ht = bt = z1
        cost = torch.zeros((), device=dev)
        if has_scene:
            ts = scene_terms(prob, huber_scene)
            if not no_free_poses:
                Hcc, bc = assemble_camera_system(ts, prob.scene.tgt, prob.scene.host, K)
            Wr, Hr, br = assemble_landmark_system(
                ts, prob.scene.tgt, prob.scene.host, prob.scene.point, P, K, 1,
                with_coupling=not no_free_poses)
            cost = cost + ts["cost"].sum()
        if has_text:
            tt = text_terms(prob, huber_text, text_pair_feat)
            if not no_free_poses:
                H2, b2 = assemble_camera_system(tt, prob.text.tgt, prob.text.host, K)
                Hcc = Hcc + H2
                bc = bc + b2
            Wt, Ht, bt = assemble_landmark_system(
                tt, prob.text.tgt, prob.text.host, prob.text.text, T, K, 3,
                with_coupling=not no_free_poses)
            cost = cost + tt["cost"].sum()
        return (Hcc, bc, Wr, Hr, br, Wt, Ht, bt), cost

    def params_of(prob):
        return (prob.poses, prob.rho) + ((prob.theta,) if problem.theta is not None else ())

    def with_params(params):
        if len(params) == 3:
            return problem._replace(poses=params[0], rho=params[1], theta=params[2])
        return problem._replace(poses=params[0], rho=params[1])

    # deferred-accept LM: ONE build per iteration. The trial's build gives
    # its cost (accept/reject against the best) and, on accept, the next
    # linearization; on reject the best system is retried with more damping
    best = params_of(problem)
    best_cost = torch.tensor(float("inf"), device=dev)
    best_sys = None
    trial = best
    lam = torch.tensor(lam0, dtype=torch.float32, device=dev)
    assemble = build if build_override is None else build_override
    for it in range(n_iters + 1):
        sys_t, cost_t = assemble(with_params(trial))
        if best_sys is None:  # the first build always wins unless non-finite
            best_sys = tuple(torch.zeros_like(a) for a in sys_t)
        finite = torch.isfinite(cost_t)
        for p in trial:
            finite = finite & torch.isfinite(p).all()
        accept = (cost_t < best_cost) & finite
        best = tuple(torch.where(accept, a, b) for a, b in zip(trial, best))
        best_cost = torch.where(accept, cost_t, best_cost)
        best_sys = tuple(torch.where(accept, a, b) for a, b in zip(sys_t, best_sys))
        lam = torch.where(accept, lam * lam_down, lam * lam_up).clamp(lam_min, lam_max)
        if it == n_iters:
            break  # the JAX scan's last step computes a trial nobody reads
        step = damped_step(problem, best_sys, lam, no_free_poses)
        new = apply_update(with_params(best), *step)
        trial = new if len(best) == 3 else new[:2]
    return LMState(poses=best[0], rho=best[1], theta=best[2] if len(best) == 3 else None,
                   lam=lam, cost=best_cost)


def scene_chi2(problem: BAProblem, huber: float):
    """Post-solve per-observation chi2 for outlier gating."""
    ts = scene_terms(problem, huber)
    return ts["chi2"], ts["w"] > 0
