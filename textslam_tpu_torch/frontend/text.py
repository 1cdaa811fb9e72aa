"""Text-object pipeline: planar text landmarks tracked by direct photometric
alignment, with their semantic lifecycle. Port of
textslam_tpu/frontend/text.py along the per-frame chained path.

- theta initialization by 3-point RANSAC over scene-point (ray, rho)
  constraints in the detection box, or over KLT tracks of the box;
- per-level reference features: the strongest-gradient in-box pixels with
  the 8-sample INTERVAL8 pattern and box-normalized intensities;
- per-frame gates: orientation cos >= 0.5, box in image (+-6 px), ZNCC;
- joint scene+text pose refinement coarse-to-fine over pyramid levels,
  chained after the scene track step (fused_frame_chain);
- theta-only multi-view refinement of IMMATURE objects every frame and
  their IMMATURE -> GOOD promotion;
- label data association of detections, semantic string fusion and the
  good/bad demotion counters;
- the coarse-to-fine windowed joint BA schedule at keyframe insertion
  (fused_ba_schedule);
- the loop-time theta pass of the landmark-only refinement at global-map
  scale (landmark_theta_pass).

The JAX package compiles each `fused_*` program into one XLA executable;
here they are plain functions on tensors that run eagerly, with the same
inputs and outputs. vmap'd per-pair/per-object work has an explicit batch
axis, and lax.scan / fori_loop are Python loops. Theta RANSAC draws its
Gumbel keys from a seeded torch.Generator (the JAX PRNG stream cannot be
reproduced), and top-k selections use a stable descending sort so ties keep
the lower index as lax.top_k does. Every host->device crossing names its
dtype.

The device-mesh path of the windowed BA (Tracker._local_ba under a mesh)
builds each level's rows with build_text_obs, from the same per-level code
as fused_ba_schedule (_level_text_obs), so both paths solve the same rows.
Where the JAX package's build_text_obs takes mu/sigma at the thetas and host
poses the solve started from, the port takes them at the current estimate,
as both packages' fused schedule does.

Not here: the gate-only per-frame hook of frames without a pyramid
(on_frame_tracked; with text on every frame has one).
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import torch

from ..config import TextSLAMConfig
from ..geometry import plane, se3, se3_np
from ..geometry.camera import project, unproject
from ..mapper.state import TEXT_BAD, TEXT_GOOD, TEXT_IMMATURE, SlamMap
from ..ops import klt, rasterize
from ..ops.interp import bilinear
from ..ops.zncc import zncc_gate
from ..solver import ba
from ..utils.profiling import phase
from .tracking import _bool, _f32, _i64, pad_tier

log = logging.getLogger(__name__)

# INTERVAL8 neighbour offsets in pixels
INTERVAL8 = np.array(
    [[0, 0], [2, 0], [-2, 0], [0, 2], [0, -2], [1, -1], [-1, 1], [-1, -1]],
    np.float32,
)


def _i8(device) -> torch.Tensor:
    return torch.as_tensor(INTERVAL8, device=device)


def _topk_stable(x: torch.Tensor, k: int):
    """The k largest values along the last axis and their indices, ties
    keeping the lower index first (lax.top_k's order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def extract_text_features(level_img, level_grad, quad, mu, sigma, n_feat: int,
                          valid_shape=None):
    """Select the n_feat strongest-gradient in-box pixels and record their
    8-sample normalized reference intensities.

    level_img [H, W], level_grad [H, W, 2], quad [..., 4, 2] (level px), box
    stats mu / sigma [...]. valid_shape (h, w) gates the in-image test to the
    true level extent of a padded pyramid slice. Returns (uv [..., F, 2],
    ref [..., F, 8], valid [..., F])."""
    H, W = level_img.shape
    h, w = (H, W) if valid_shape is None else valid_shape
    dev = level_img.device
    mask = rasterize.quad_mask(quad, H, W)
    gmag = level_grad[..., 0].abs() + level_grad[..., 1].abs()
    u = torch.arange(W, device=dev)[None, :]
    v = torch.arange(H, device=dev)[:, None]
    inb = (u >= 2) & (u < w - 2) & (v >= 2) & (v < h - 2)  # the pattern stays inside
    score = torch.where(mask & inb, gmag, torch.zeros_like(gmag))
    vals, idx = _topk_stable(score.reshape(score.shape[:-2] + (-1,)), n_feat)
    vy = idx // W
    uv = torch.stack([idx - vy * W, vy], dim=-1).float()
    valid = vals > 1e-3
    pos = uv[..., :, None, :] + _i8(dev)  # [..., F, 8, 2]
    inten, ok = bilinear(level_img, pos)
    mu = torch.as_tensor(mu, device=dev)[..., None, None]
    sigma = torch.as_tensor(sigma, device=dev)[..., None, None]
    return uv, (inten - mu) / sigma, valid & ok.all(-1)


def _extract_reference(pyr_dev, shapes: np.ndarray, quad0, n_levels: int, n_feat: int,
                       n_box: int):
    """All per-level reference features + the level-0 ZNCC box subsample of
    one new text object, packed into one flat float32 tensor laid out as
    [uv (L*F*2) | ref (L*F*8) | valid (L*F) | mu_sigma (L*2) |
     box_uv (n_box*2) | box_int (n_box) | box_valid (n_box)]
    so the host reads it back once. pyr_dev [L, H, W, 3] packed pyramid,
    shapes [L, 2] true extents, quad0 [4, 2] level-0 px."""
    uvs, refs, vals, mss = [], [], [], []
    for lv in range(n_levels):
        img = pyr_dev[lv, :, :, 0]
        grad = pyr_dev[lv, :, :, 1:3]
        h, w = int(shapes[lv, 0]), int(shapes[lv, 1])
        quad_l = quad0 / (2.0 ** lv)
        mu, sigma, _ = rasterize.quad_stats(img, quad_l, valid_shape=(h, w))
        uv, ref, valid = extract_text_features(img, grad, quad_l, mu, sigma, n_feat,
                                               valid_shape=(h, w))
        uvs.append(uv)
        refs.append(ref)
        vals.append(valid)
        mss.append(torch.stack([mu, sigma]))
    # level-0 box pixels for the ZNCC gate: an evenly strided row-major
    # subsample of the in-box pixels
    H, W = pyr_dev.shape[1:3]
    dev = pyr_dev.device
    img0 = pyr_dev[0, :, :, 0]
    inb = ((torch.arange(W, device=dev)[None, :] < int(shapes[0, 1]))
           & (torch.arange(H, device=dev)[:, None] < int(shapes[0, 0])))
    mask = (rasterize.quad_mask(quad0, H, W) & inb).reshape(-1)
    rank = torch.cumsum(mask.long(), 0) - 1  # row-major index among in-box pixels
    stride = (mask.sum() // n_box).clamp(min=1)
    sel = mask & (rank % stride == 0) & (rank // stride < n_box)
    big = 2 ** 30
    key = torch.where(sel, rank // stride, torch.full_like(rank, big))
    order = torch.sort(key, stable=True)[1][:n_box]
    bvalid = key[order] < big
    by = order // W
    return torch.cat([
        torch.stack(uvs).reshape(-1), torch.stack(refs).reshape(-1),
        torch.stack(vals).float().reshape(-1), torch.stack(mss).reshape(-1),
        torch.stack([order - by * W, by], dim=-1).float().reshape(-1),
        img0.reshape(-1)[order], bvalid.float(),
    ])


def _batch_project_quads(quads_px, thetas, host_poses, target_pose, fx, fy, cx, cy):
    """Project text quads host->target through their planes: quads_px
    [T, 4, 2] host level-0 px, thetas [T, 3], host_poses [T, 7],
    target_pose [7] -> (uv [T, 4, 2], z [T, 4]) at level-0 scale."""
    rays = unproject(quads_px, fx, fy, cx, cy)
    T_cr = se3.relative(target_pose[None, :], host_poses)  # [T, 7]
    p_c = plane.project_to_target(rays, thetas[:, None, :], T_cr[:, None, :])
    return project(p_c, fx, fy, cx, cy), p_c[..., 2]


def _gates(pose_cw, quads, thetas, host_poses, live, box_uv, box_int, box_valid, img0,
           fx, fy, cx, cy, margin, cos_min, zncc_min, width: int, height: int):
    """All TextJudge gates for the whole text pool in one pass: box in the
    image (+-margin) in front of the camera, orientation cos, ZNCC of the
    level-0 box pixels through the plane. Returns (geo [T], full [T],
    zncc [T])."""
    uv, z = _batch_project_quads(quads, thetas, host_poses, pose_cw, fx, fy, cx, cy)
    in_img = (((uv[..., 0] >= -margin) & (uv[..., 0] < width + margin)
               & (uv[..., 1] >= -margin) & (uv[..., 1] < height + margin)).all(-1)
              & (z > 0.05).all(-1))
    # orientation: world normal vs the viewing ray at the box center
    rays = unproject(quads, fx, fy, cx, cy)
    p_r = plane.backproject(rays, thetas[:, None, :])
    center_w = se3.apply(se3.inverse(host_poses)[:, None, :], p_r).mean(dim=1)
    cam_center = se3.apply(se3.inverse(pose_cw), torch.zeros(3, device=pose_cw.device))
    cosv = plane.view_cos(thetas, host_poses, cam_center[None, :], center_w)
    geo = live & in_img & (cosv >= cos_min)
    brays = unproject(box_uv, fx, fy, cx, cy)
    T_cr = se3.relative(pose_cw[None, :], host_poses)
    p_c = plane.project_to_target(brays, thetas[:, None, :], T_cr[:, None, :])
    sc, n = zncc_gate(box_int, box_valid & (p_c[..., 2] > 0.05), img0,
                      project(p_c, fx, fy, cx, cy))
    return geo, geo & (sc >= zncc_min) & (n >= 16), sc


def _seed_features(img0, grad0, quads, n_feat: int):
    """In-box strongest-gradient seed features of all unmapped boxes of a
    KF: quads [D, 4, 2] -> flat float32 [D*F*2 + D*F] (uv, then valid)."""
    mu, sigma, _ = rasterize.quad_stats(img0, quads)
    uv, _, val = extract_text_features(img0, grad0, quads, mu, sigma, n_feat)
    return torch.cat([uv.reshape(-1), val.float().reshape(-1)])


def _theta_ransac(gen: torch.Generator, rays, rhos, valid):
    """3-point theta RANSAC (64 hypotheses drawn by Gumbel keys) with a
    least-squares refit on the inliers. rays [N, 3], rhos [N], valid [N] ->
    (theta [3], inliers [N], ok)."""
    N = rays.shape[0]
    S = 64  # hypothesis count
    u = torch.rand((S, N), generator=gen, device=rays.device).clamp(min=1e-30)
    g = torch.where(valid[None, :], -torch.log(-torch.log(u)), torch.full_like(u, -float("inf")))
    idx = _topk_stable(g, 3)[1]  # [S, 3]
    th = plane.solve_theta_3pt(rays[idx], rhos[idx])  # [S, 3]
    pred = -(rays[None, :, :] * th[:, None, :]).sum(-1)  # [S, N]
    rel = (pred - rhos[None, :]).abs() / rhos[None, :].abs().clamp(min=1e-6)
    inl = (rel < 0.15) & valid[None, :] & (pred > 1e-6)
    inliers = inl[torch.argmax(inl.sum(-1))]
    theta = plane.fit_theta_lstsq(rays, rhos, inliers.float())
    pred2 = -(rays * theta).sum(-1)
    rel2 = (pred2 - rhos).abs() / rhos.abs().clamp(min=1e-6)
    inliers = (rel2 < 0.15) & valid & (pred2 > 1e-6)
    # degeneracy gate: nearly collinear support satisfies the rho
    # constraints equally well with a wrong normal, so the inlier rays' 2D
    # scatter must be 2-dimensional (eigenvalue ratio of the second moment)
    wi = inliers.float()
    nw = wi.sum().clamp(min=1.0)
    mxy = (rays[:, :2] * wi[:, None]).sum(0) / nw
    d = (rays[:, :2] - mxy) * wi[:, None]
    Sm = d.T @ d / nw
    tr = Sm[0, 0] + Sm[1, 1]
    disc = torch.sqrt(((Sm[0, 0] - Sm[1, 1]) * 0.5) ** 2 + Sm[0, 1] ** 2)
    ok = (inliers.sum() >= 5) & (tr * 0.5 - disc > 0.05 * (tr * 0.5 + disc))
    return theta, inliers, ok


def _level_rows(feat_uv_level, level: int, fx, fy, cx, cy):
    """Pattern rays [..., F, 8, 3] of level-px features [..., F, 2]."""
    s = 2.0 ** level
    pos = feat_uv_level[..., :, None, :] + _i8(feat_uv_level.device)
    return unproject(pos, fx / s, fy / s, cx / s, cy / s)


def _quads_at(qrays, thetas, T_cr, level: int, fx, fy, cx, cy):
    """Host quads (as rays [..., 4, 3]) projected through their planes into
    targets T_cr [..., 7], in level px."""
    s = 2.0 ** level
    p = plane.project_to_target(qrays, thetas[..., None, :], T_cr[..., None, :])
    return project(p, fx / s, fy / s, cx / s, cy / s)


def fused_pose_refine(pose0, scene, rho, theta, host_poses, quads0, feat_uv, feat_ref,
                      feat_valid, obj_valid, imgs_levels, fx, fy, cx, cy, levels: tuple,
                      n_iters: int, huber_scene: float, huber_text: float,
                      weight_text: float):
    """Joint scene+text pose refinement over the pyramid levels: per level,
    project the text quads through the planes at the current pose, take the
    target box statistics (mu, sigma), assemble the photometric rows and run
    the LM solve; the refined pose feeds the next level.

    pose0 [7]; scene: SceneObs (pose slot 0, hosts frozen); rho [P]; theta
    [T, 3], host_poses [T, 7], quads0 [T, 4, 2] (host level-0 px); feat_uv
    [T, L, F, 2], feat_ref [T, L, F, 8], feat_valid [T, L, F]; obj_valid
    [T]; imgs_levels: [H_l, W_l, 3] level images of the current frame,
    aligned with `levels`. Returns the refined pose [7]."""
    T, _, F, _ = feat_uv.shape
    dev = pose0.device
    pose = pose0
    Pt = rho.shape[0]
    scene = scene._replace(point=scene.point.clamp(0, Pt - 1))
    qrays = unproject(quads0, fx, fy, cx, cy)
    O = T * F
    for i, level in enumerate(levels):
        img = imgs_levels[i]
        quad_t = _quads_at(qrays, theta, se3.relative(pose[None, :], host_poses), level,
                           fx, fy, cx, cy)
        mu, sigma, _ = rasterize.quad_stats(img[..., 0], quad_t)
        tobs = ba.TextObs(
            tgt=torch.zeros(O, dtype=torch.int64, device=dev),
            host=torch.ones(O, dtype=torch.int64, device=dev),  # dump slot (frozen hosts)
            host_frozen_pose=host_poses.repeat_interleave(F, dim=0),
            host_in_window=torch.zeros(O, dtype=torch.bool, device=dev),
            text=torch.arange(T, device=dev).repeat_interleave(F),
            rays=_level_rows(feat_uv[:, level], level, fx, fy, cx, cy).reshape(O, 8, 3),
            ref_inten=feat_ref[:, level].reshape(O, 8),
            mu_sigma=torch.stack([mu.repeat_interleave(F), sigma.repeat_interleave(F)], -1),
            weight=torch.full((O,), weight_text, device=dev),
            valid=(feat_valid[:, level] & obj_valid[:, None]).reshape(O),
            level=level,
        )
        prob = ba.BAProblem(
            poses=pose[None], pose_free=torch.ones(1, dtype=torch.bool, device=dev),
            rho=rho, rho_free=torch.zeros(Pt, dtype=torch.bool, device=dev),
            scene=scene, theta=theta, theta_free=torch.zeros(T, dtype=torch.bool, device=dev),
            text=tobs, images=img[None], fx=fx, fy=fy, cx=cx, cy=cy,
        )
        st = ba.solve_ba(prob, n_iters=n_iters, huber_scene=huber_scene,
                         huber_text=huber_text, text_pair_feat=F)
        pose = st.poses[0]
    return pose


def fused_text_frame(pose0, scene, rho, kp_packed, kp_sel, quads, thetas, hposes, live,
                     good_state, box_uv, box_int, box_valid, feat_uv, feat_ref, feat_valid,
                     imgs_levels, img0, fx, fy, cx, cy, margin, cos_min, zncc_min,
                     width: int, height: int, levels: tuple, n_iters: int,
                     huber_scene: float, huber_text: float, weight_text: float):
    """The per-frame text hook: gates -> joint scene+text pose refinement
    over the GOOD fully visible objects -> gates again at the refined pose.
    Returns [3, R] float32 (R = max(pool tier, 16)): row0 geo mask, row1
    full mask, row2 = [pose (7), finest-level text rows, any_vis].

    When nothing is visible the pose stays pose0; the JAX program computes
    the refinement anyway and discards it, here it is skipped (one host
    read of the visibility flag)."""
    scene = scene._replace(uv=kp_packed[kp_sel, 0:2])
    gate_args = (quads, thetas, hposes, live, box_uv, box_int, box_valid, img0,
                 fx, fy, cx, cy, margin, cos_min, zncc_min, width, height)
    _, full1, _ = _gates(pose0, *gate_args)
    vis = full1 & good_state
    text_rows = (feat_valid[:, 0] & vis[:, None]).sum()
    any_vis = bool(vis.any())
    pose_out = pose0
    if any_vis:
        pose_out = fused_pose_refine(
            pose0, scene, rho, thetas, hposes, quads, feat_uv, feat_ref, feat_valid, vis,
            imgs_levels, fx, fy, cx, cy, levels=levels, n_iters=n_iters,
            huber_scene=huber_scene, huber_text=huber_text, weight_text=weight_text)
    geo2, full2, _ = _gates(pose_out, *gate_args)
    Tt = quads.shape[0]
    R = max(Tt, 16)
    out = torch.zeros((3, R), device=pose0.device)
    out[0, :Tt] = geo2.float()
    out[1, :Tt] = full2.float()
    out[2, :7] = pose_out
    out[2, 7] = text_rows.float()
    out[2, 8] = float(any_vis)
    return out


def fused_frame_chain(pt_ray, pt_rho_pool, pt_host_pose, pt_desc, pt_desc_alt, pt_valid,
                      guess, kp_packed, quads, thetas, hposes, live, good_state,
                      box_uv, box_int, box_valid, feat_uv, feat_ref, feat_valid,
                      imgs_levels, img0, fx, fy, cx, cy, radius, max_dist, weight_scene,
                      margin, cos_min, zncc_min, width: int, height: int, rounds: int,
                      track_n_iters: int, chi2_gate: float, levels: tuple, n_iters: int,
                      huber_scene: float, huber_text: float, weight_text: float):
    """The whole per-frame device pipeline: the scene track step (match ->
    optimize -> re-associate -> re-optimize) feeds the text hook (gates ->
    joint refine -> re-gate) without the host in between. The hook's scene
    observations are the track step's final (ok & inlier) associations,
    gathered by index from the packed keypoint pool.

    Returns one flat float32 tensor [track rows 4*P | hook rows 3*R] for a
    single readback (fused_track_step's [4, P], fused_text_frame's [3, R])."""
    from .tracking import fused_track_step

    out1 = fused_track_step(
        pt_ray, pt_rho_pool, pt_host_pose, pt_desc, pt_desc_alt, pt_valid,
        guess, kp_packed, fx, fy, cx, cy, radius, max_dist, weight_scene,
        width=width, height=height, rounds=rounds, n_iters=track_n_iters,
        huber=huber_scene, chi2_gate=chi2_gate)
    P = out1.shape[1]
    Pt = pt_rho_pool.shape[0]
    dev = out1.device
    scene = ba.SceneObs(
        tgt=torch.zeros(P, dtype=torch.int64, device=dev),
        host=torch.ones(P, dtype=torch.int64, device=dev),
        host_frozen_pose=pt_host_pose,
        host_in_window=torch.zeros(P, dtype=torch.bool, device=dev),
        point=torch.arange(P, device=dev).clamp(max=Pt - 1),
        ray=pt_ray,
        uv=torch.zeros((P, 2), device=dev),  # gathered in fused_text_frame
        weight=torch.full((P,), weight_scene, device=dev),
        valid=(out1[1] > 0.5) & (out1[2] > 0.5),
    )
    out2 = fused_text_frame(
        out1[3, :7], scene, pt_rho_pool, kp_packed, out1[0].long(),
        quads, thetas, hposes, live, good_state, box_uv, box_int, box_valid,
        feat_uv, feat_ref, feat_valid, imgs_levels, img0,
        fx, fy, cx, cy, margin, cos_min, zncc_min, width=width, height=height,
        levels=levels, n_iters=n_iters, huber_scene=huber_scene, huber_text=huber_text,
        weight_text=weight_text)
    return torch.cat([out1.reshape(-1), out2.reshape(-1)])


def _theta_problem(poses, theta, theta_free, tgt, host, host_pose, text, rays, ref, mu, sigma,
                   F: int, valid, level: int, imgs, weight_text: float, fx, fy, cx, cy):
    """A theta-only photometric BAProblem (every pose frozen)."""
    O = tgt.shape[0]
    dev = poses.device
    tobs = ba.TextObs(
        tgt=tgt, host=host, host_frozen_pose=host_pose,
        host_in_window=torch.zeros(O, dtype=torch.bool, device=dev), text=text,
        rays=rays, ref_inten=ref,
        mu_sigma=torch.stack([mu.repeat_interleave(F), sigma.repeat_interleave(F)], -1),
        weight=torch.full((O,), weight_text, device=dev), valid=valid, level=level,
    )
    return ba.BAProblem(
        poses=poses, pose_free=torch.zeros(poses.shape[0], dtype=torch.bool, device=dev),
        rho=torch.zeros(16, device=dev), rho_free=torch.zeros(16, dtype=torch.bool, device=dev),
        theta=theta, theta_free=theta_free, text=tobs, images=imgs,
        fx=fx, fy=fy, cx=cx, cy=cy,
    )


def fused_theta_optimize(theta0, poses, tgt_valid, host_pose, quad0, feat_uv, feat_ref,
                         feat_valid_per_kf, imgs_levels, fx, fy, cx, cy, levels: tuple,
                         n_iters: int, huber_theta: float, weight_text: float):
    """theta-only multi-view refinement of one object over the pyramid
    levels (PyrThetaOptim).

    theta0 [3]; poses [K, 7] frozen target poses with validity tgt_valid
    [K]; host_pose [7]; quad0 [4, 2] host level-0 px; feat_uv [L, F, 2] /
    feat_ref [L, F, 8]; feat_valid_per_kf [K, L, F]; imgs_levels: [K, H_l,
    W_l, 3] target stacks aligned with `levels`. Returns (theta [3], H
    [3, 3] Gauss-Newton information at the solution)."""
    K = poses.shape[0]
    F = feat_uv.shape[1]
    dev = poses.device
    theta = theta0[None]  # a landmark pool of one
    O = K * F
    qrays = unproject(quad0, fx, fy, cx, cy)  # [4, 3]
    T_cr = se3.relative(poses, host_pose[None, :])  # [K, 7]
    tgt = torch.arange(K, device=dev).repeat_interleave(F)
    last = None
    for i, level in enumerate(levels):
        imgs = imgs_levels[i]
        quad_t = _quads_at(qrays[None], theta[0][None].expand(K, 3), T_cr, level, fx, fy, cx, cy)
        mu, sigma, _ = rasterize.quad_stats(imgs[..., 0], quad_t)
        rays = _level_rows(feat_uv[level], level, fx, fy, cx, cy)  # [F, 8, 3]
        prob = _theta_problem(
            poses, theta, torch.ones(1, dtype=torch.bool, device=dev), tgt,
            torch.full((O,), K, dtype=torch.int64, device=dev), host_pose.expand(O, 7),
            torch.zeros(O, dtype=torch.int64, device=dev),
            rays[None].expand(K, F, 8, 3).reshape(O, 8, 3),
            feat_ref[level][None].expand(K, F, 8).reshape(O, 8), mu, sigma, F,
            (feat_valid_per_kf[:, level] & tgt_valid[:, None]).reshape(O), level, imgs,
            weight_text, fx, fy, cx, cy)
        theta = ba.solve_ba(prob, n_iters=n_iters, huber_text=huber_theta, text_pair_feat=F).theta
        last = prob._replace(theta=theta)
    tt = ba.text_terms(last, huber_theta, pair_feat=F)
    Jl = tt["J_l"]  # [O, 8, 3]
    H = torch.einsum("ori,orj->ij", Jl * tt["w"][:, None, None], Jl)
    return theta[0], H


def fused_theta_optimize_all(theta0, host_poses, quads0, poses, tgt_img, tgt_valid, obj_valid,
                             feat_uv, feat_ref, feat_valid_per_kf, imgs_levels,
                             fx, fy, cx, cy, levels: tuple, n_iters: int,
                             huber_theta: float, weight_text: float):
    """Batched theta-only refinement of ALL IMMATURE objects at once
    (TextUpdate), with LM accept/reject and damping per object: theta-only
    normal equations are block-diagonal, so this is N independent solves.

    theta0 [N, 3]; host_poses [N, 7]; quads0 [N, 4, 2]; poses [M, 7]
    distinct frozen target poses; tgt_img [N, Kt] indices into them;
    tgt_valid [N, Kt]; obj_valid [N]; feat_uv [N, L, F, 2] / feat_ref
    [N, L, F, 8]; feat_valid_per_kf [N, Kt, L, F]; imgs_levels: [M, H_l, W_l,
    3] aligned with `levels`. Returns (theta [N, 3], H [N, 3, 3], cost [N])."""
    N, Kt = tgt_img.shape
    F = feat_uv.shape[2]
    M = poses.shape[0]
    dev = poses.device
    O = N * Kt * F
    tgt_flat = tgt_img.reshape(-1)  # [N*Kt]
    text_idx = torch.arange(N, device=dev).repeat_interleave(Kt * F)
    tgt_rows = tgt_flat.repeat_interleave(F)
    hp_rows = host_poses.repeat_interleave(Kt * F, dim=0)  # [O, 7]
    qrays = unproject(quads0, fx, fy, cx, cy)  # [N, 4, 3]
    T_cr = se3.relative(poses[tgt_flat].reshape(N, Kt, 7), host_poses[:, None, :])
    lam0, lam_up, lam_down = 1e-4, 10.0, 0.1
    eye3 = torch.eye(3, device=dev)

    theta = theta0
    H_best = torch.zeros((N, 3, 3), device=dev)
    cost_best = torch.full((N,), float("inf"), device=dev)
    for i, level in enumerate(levels):
        imgs = imgs_levels[i]
        # box statistics at the CURRENT theta (the problem-build recompute)
        quad_t = _quads_at(qrays[:, None], theta[:, None, :].expand(N, Kt, 3), T_cr, level,
                           fx, fy, cx, cy)  # [N, Kt, 4, 2]
        mu, sigma, _ = rasterize.quad_stats(imgs[tgt_flat, ..., 0], quad_t.reshape(-1, 4, 2))
        rays = _level_rows(feat_uv[:, level], level, fx, fy, cx, cy)  # [N, F, 8, 3]
        prob = _theta_problem(
            poses, theta, obj_valid, tgt_rows, torch.full((O,), M, dtype=torch.int64, device=dev),
            hp_rows, text_idx, rays[:, None].expand(N, Kt, F, 8, 3).reshape(O, 8, 3),
            feat_ref[:, level][:, None].expand(N, Kt, F, 8).reshape(O, 8), mu, sigma, F,
            (feat_valid_per_kf[:, :, level] & tgt_valid[:, :, None]
             & obj_valid[:, None, None]).reshape(O),
            level, imgs, weight_text, fx, fy, cx, cy)

        def obj_terms(th):
            tt = ba.text_terms(prob._replace(theta=th), huber_theta, pair_feat=F)
            Jw = tt["J_l"] * tt["w"][:, None, None]  # [O, 8, 3]
            H = torch.einsum("ori,orj->oij", Jw, tt["J_l"])
            g = torch.einsum("ori,or->oi", Jw, tt["r"])
            # rows are [n, kt, f]-grouped: a reshape-reduce per object
            return (H.reshape(N, Kt * F, 3, 3).sum(1), g.reshape(N, Kt * F, 3).sum(1),
                    tt["cost"].reshape(N, Kt * F).sum(1))

        # deferred-accept LM, all state [N]-batched, one build per iteration
        best_th, best_cost = theta, torch.full((N,), float("inf"), device=dev)
        best_H, best_g = torch.zeros((N, 3, 3), device=dev), torch.zeros((N, 3), device=dev)
        trial, lam = theta, torch.full((N,), lam0, device=dev)
        for it in range(n_iters + 1):
            H_t, g_t, cost_t = obj_terms(trial)
            accept = (cost_t < best_cost) & torch.isfinite(cost_t) & torch.isfinite(trial).all(-1)
            am = accept[:, None]
            best_th = torch.where(am, trial, best_th)
            best_cost = torch.where(accept, cost_t, best_cost)
            best_H = torch.where(am[..., None], H_t, best_H)
            best_g = torch.where(am, g_t, best_g)
            lam = torch.where(accept, lam * lam_down, lam * lam_up).clamp(1e-12, 1e8)
            if it == n_iters:
                break  # the JAX scan's last step computes a trial nobody reads
            # the damping of solve_ba's theta block: H + diag(lam * diag(H) + 1e-8)
            Hd = best_H + (lam[:, None, None] * best_H + 1e-8) * eye3
            dth = (ba.inv3x3_spd(Hd) @ -best_g[..., None])[..., 0]
            trial = best_th + dth * obj_valid[:, None]
        theta, cost_best, H_best = best_th, best_cost, best_H
    return theta, H_best, cost_best


def _pad_rows(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    """a padded along its first axis to n rows of `fill`."""
    return np.pad(a, [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1), constant_values=fill)


def _level_text_obs(cur, rows, qrays, pair_lm, pair_tgt, pair_host, pair_hiw, pair_hpose,
                    feat_uv, ref, fvalid, imgs, level: int, weight_rows, fx, fy, cx, cy):
    """The text rows of one pyramid level at the CURRENT estimate of `cur`
    (poses, thetas): each (object, target) pair's host quad projected through
    its plane into the target, its (mu, sigma) in the target's level image,
    and the pattern rays of the pair's features at this level."""
    F = feat_uv.shape[1]
    O = pair_lm.shape[0] * F
    poses_ext = torch.cat([cur.poses, se3.identity((1,), device=cur.poses.device)], 0)
    hpose = torch.where(pair_hiw[:, None], poses_ext[pair_host], pair_hpose)
    quad_t = _quads_at(qrays, cur.theta[pair_lm], se3.relative(poses_ext[pair_tgt], hpose),
                       level, fx, fy, cx, cy)
    mu, sigma, _ = rasterize.quad_stats(imgs[pair_tgt, ..., 0], quad_t)
    return ba.TextObs(
        tgt=rows["tgt"], host=rows["host"], host_frozen_pose=rows["hp"],
        host_in_window=rows["hiw"], text=rows["text"],
        rays=_level_rows(feat_uv, level, fx, fy, cx, cy).reshape(O, 8, 3),
        ref_inten=ref,
        mu_sigma=torch.stack([mu.repeat_interleave(F),
                              sigma.clamp(min=1e-3).repeat_interleave(F)], -1),
        weight=weight_rows, valid=fvalid, level=level)


def fused_ba_schedule(prob, rows, pair_quads, pair_lm, pair_tgt, pair_host, pair_hiw,
                      pair_hpose, feat_uv_lv, ref_lv, fvalid_lv, imgs_lv, fx, fy, cx, cy,
                      levels: tuple, n_iters: int, huber_scene: float, huber_text: float,
                      weight_text: float, pair_feat: int, gate: bool, no_free_poses: bool,
                      lam0: float = 1e-4, lam_up: float = 10.0, lam_down: float = 0.1,
                      lam_min: float = 1e-12, lam_max: float = 1e8):
    """The coarse-to-fine windowed joint BA: per level, pair geometry (quad
    projection, mu/sigma at the CURRENT estimate, pattern rays), the text
    rows, the deferred-accept LM, and optionally the unweighted per-sample
    gate errors; then the scene chi2. `prob` carries the scene rows, pools
    and initial parameters (text=None, images=None).

    Returns one flat float32 tensor: poses K*7 | rho P | scene chi2 O_s |
    theta T*3 | per level (|err| 8 | ok 8) Np*F*16 (only when gate)."""
    F = pair_feat
    O = pair_quads.shape[0] * F
    qrays = unproject(pair_quads, fx, fy, cx, cy)  # [Np, 4, 3]
    weight_rows = torch.full((O,), weight_text, device=prob.poses.device)
    cur = prob
    gates = []
    for li, level in enumerate(levels):
        imgs = imgs_lv[li]
        tobs = _level_text_obs(cur, rows, qrays, pair_lm, pair_tgt, pair_host, pair_hiw,
                               pair_hpose, feat_uv_lv[li], ref_lv[li], fvalid_lv[li], imgs,
                               level, weight_rows, fx, fy, cx, cy)
        cur = cur._replace(text=tobs, images=imgs)
        st = ba._solve_ba_body(cur, n_iters, huber_scene, huber_text, lam0, lam_up, lam_down, F,
                               lam_min=lam_min, lam_max=lam_max, no_free_poses=no_free_poses)
        cur = cur._replace(poses=st.poses, rho=st.rho, theta=st.theta)
        if gate:
            err, ok = ba.text_sample_errors(cur, pair_feat=F)
            gates.append(torch.cat([err, ok.float()], dim=-1).reshape(-1))
    chi2, _ = ba.scene_chi2(cur._replace(text=None, images=None), huber_scene)
    return torch.cat([cur.poses.reshape(-1), cur.rho, chi2, cur.theta.reshape(-1)] + gates)


# the pyramid levels KLT tracks new text boxes on (klt_track's levels 3..0)
KLT_LEVELS = 4
# the KLT accumulator's arrays in a checkpoint: key suffix -> accumulator key
_KLT_HOST = {"uv_host": "uv_host", "valid": "valid", "det_idx": "det_idx"}
_KLT_DEV = {"uv_cur": "uv_cur_dev", "valid_cur": "valid_dev"}


class TextFrontend:
    """Text objects of one TextSLAM run: creation, per-frame gates and
    maturation, keyframe association, and the windowed BA's text inputs.
    Host numpy bookkeeping over SlamMap's pools; device work through the
    functions above on `device`."""

    def __init__(self, cfg: TextSLAMConfig, slam_map: SlamMap, tracker, *, device):
        from .frame import check_device

        self.cfg = cfg
        self.map = slam_map
        self.tracker = tracker
        self.device = check_device(device, "TextFrontend")
        self.levels = cfg.pyramid.pose_levels  # (2, 1, 0)
        m = cfg.map
        B = min(cfg.text.max_box_pixels, 1024)
        self.B = B
        self.tx_box_uv = np.zeros((m.max_texts, B, 2), np.float32)
        self.tx_box_int = np.zeros((m.max_texts, B), np.float32)
        self.tx_box_valid = np.zeros((m.max_texts, B), bool)
        L = max(cfg.pyramid.init_ba_levels) + 1
        self.n_levels = L
        self.tx_host_stats = np.zeros((m.max_texts, L, 2), np.float32)
        # theta RANSAC's Gumbel keys (the JAX package keys PRNGKey(seed + 1))
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        # text rows of the latest pose refinement: the tracker's sparse-text
        # chi2 relaxation reads it
        self.last_text_rows = 0
        # per-frame KLT accumulator of NEW (unmapped) text boxes: seeded at
        # each KF, advanced every frame, consumed at the next KF
        self._klt = None
        # device cache of the append-only per-object pools (box pixels +
        # reference features), re-uploaded only when an object is created
        self._pool_version = 0
        self._pool_dev_cache = {}  # (version, Tt) -> tensors
        self._imm_rr = 0  # round-robin cursor of the maturation budget
        # optional [n_texts]-mask filter of the live objects the gates and
        # the per-frame hook see (tests inject drift / amnesia here)
        self.pool_mask_hook = None

    # ------------------------------------------------------------------
    def _kf_has_pyr(self, kid: int) -> bool:
        return self.map.keyframes[kid].pyr_shapes is not None

    def _pool_dev(self, Tt: int):
        """Device copies of the append-only pools at tier Tt: (box_uv
        [Tt, B, 2], box_int [Tt, B], box_valid [Tt, B], feat_uv
        [Tt, L, F, 2], feat_ref [Tt, L, F, 8], feat_valid [Tt, L, F])."""
        key = (self._pool_version, Tt)
        if key in self._pool_dev_cache:
            return self._pool_dev_cache[key]
        m = self.map
        n = min(m.n_texts, Tt)
        dev = self.device

        def padded(a, dtype):
            out = np.zeros((Tt,) + a.shape[1:], dtype)
            out[:n] = a[:n]
            return torch.as_tensor(out, device=dev)

        arrs = (padded(self.tx_box_uv, np.float32), padded(self.tx_box_int, np.float32),
                padded(self.tx_box_valid, bool), padded(m.tx_feat_uv, np.float32),
                padded(m.tx_feat_ref, np.float32), padded(m.tx_feat_valid, bool))
        # stale versions go; at most two tiers stay resident
        for k in [k for k in self._pool_dev_cache if k[0] != self._pool_version]:
            del self._pool_dev_cache[k]
        while len(self._pool_dev_cache) > 1:
            self._pool_dev_cache.pop(next(iter(self._pool_dev_cache)))
        self._pool_dev_cache[key] = arrs
        return arrs

    def _theta_ransac(self, rays: np.ndarray, rhos: np.ndarray, valid: np.ndarray):
        """theta RANSAC over padded host (ray, rho) constraints: (theta [3]
        numpy, ok). One readback."""
        dev = self.device
        theta, _, ok = _theta_ransac(self._gen, _f32(rays, dev), _f32(rhos, dev),
                                     _bool(valid, dev))
        tpk = torch.cat([theta, ok[None].float()]).cpu().numpy()
        return tpk[:3], bool(tpk[3] >= 0.5)

    @staticmethod
    def _constraints(p: np.ndarray, good: np.ndarray, clip: bool = True):
        """Padded (rays, rhos, valid) of host-frame points p [n, 3]; depths
        clip at 1e-6 for triangulated points (the scene-point path divides
        by the raw depth, as the JAX package does)."""
        N = pad_tier(len(good), 16)
        rays = np.zeros((N, 3), np.float32)
        rhos = np.zeros(N, np.float32)
        valid = np.zeros(N, bool)
        zs = p[:, 2].clip(1e-6) if clip else p[:, 2]
        rays[: len(good)] = p / zs[:, None]
        rhos[: len(good)] = 1.0 / zs
        valid[: len(good)] = good
        return rays, rhos, valid

    # ------------------------------------------------------------------
    # creation
    def try_create_text(self, kid: int, det_idx: int, state=TEXT_IMMATURE) -> Optional[int]:
        """Initialize a text object from the scene points inside the
        detection box: each mapped point seen in the host KF gives a
        constraint -ray.theta = rho."""
        m = self.map
        if m.n_texts >= min(self.cfg.text.max_objects, self.cfg.map.max_texts):
            m._saturate("texts")  # counted + logged, never a silent stop
            return None
        kf = m.keyframes[kid]
        det = kf.det_text[det_idx]
        quad = det.quad
        sel = np.nonzero((kf.kp_point >= 0) & kf.obs_good)[0]
        if len(sel) == 0:
            return None
        e = np.roll(quad, -1, axis=0) - quad
        rel = kf.kp_uv[sel][:, None, :] - quad[None]
        cross = e[None, :, 0] * rel[..., 1] - e[None, :, 1] * rel[..., 0]
        sel = sel[(cross >= 0).all(-1) | (cross <= 0).all(-1)]
        if len(sel) < 5:
            return None
        p_r = se3_np.apply(m.kf_pose[kid], m.point_world(kf.kp_point[sel]))
        good_z = p_r[:, 2] > 0.05
        if good_z.sum() < 5:
            return None
        theta, ok = self._theta_ransac(*self._constraints(p_r, good_z, clip=False))
        if not ok:
            # KLT-tracked in-box features triangulated against a neighbouring
            # keyframe (TrackNewTextFeat + SolveTheta)
            theta = self._theta_from_klt(kid, quad)
            if theta is None:
                return None
        tid = m.add_text(kid, theta, quad, det.text, det.score, det.lang, state=state)
        if tid < 0:
            return None  # pool saturated (logged + counted by the map)
        self._extract_reference(tid)  # before the observation: it inherits tx_feat_valid
        m.add_text_observation(kid, tid, det_idx)
        self._fuse_semantic(tid, det, kid)
        return tid

    def _unpack_pyr(self, dev_pyr, shapes, n_levels: int = KLT_LEVELS):
        imgs = tuple(dev_pyr[lv, : int(shapes[lv][0]), : int(shapes[lv][1]), 0]
                     for lv in range(n_levels))
        grads = tuple(dev_pyr[lv, : int(shapes[lv][0]), : int(shapes[lv][1]), 1:3]
                      for lv in range(n_levels))
        return imgs, grads

    def resume_state(self) -> dict:
        """The state a resumed run needs beyond the map and the box pools,
        as numpy arrays by checkpoint key (the JAX package keeps none of
        it): the text-row count of the latest refinement (it picks the next
        frame's pose chi2 gate), the maturation budget's cursor, and the KLT
        accumulator of the latest keyframe's new boxes with the packed
        pyramid levels its tracks were last advanced on."""
        out = {"tf_last_text_rows": np.asarray(self.last_text_rows, np.int64),
               "tf_imm_rr": np.asarray(self._imm_rr, np.int64)}
        st = self._klt
        if st is not None:
            packed, shapes = st["prev_pyr"]
            out["tf_klt_host_kid"] = np.asarray(st["host_kid"], np.int64)
            out["tf_klt_last_frame_id"] = np.asarray(st.get("last_frame_id", -1), np.int64)
            for key, name in _KLT_HOST.items():
                out[f"tf_klt_{key}"] = st[name]
            for key, name in _KLT_DEV.items():
                out[f"tf_klt_{key}"] = st[name].cpu().numpy()
            out["tf_klt_prev_pyr"] = packed[:KLT_LEVELS].cpu().numpy()
            out["tf_klt_prev_shapes"] = np.asarray(shapes)[:KLT_LEVELS]
        return out

    def restore_resume_state(self, z):
        """resume_state()'s arrays back from a mapping of checkpoint keys (an
        npz), or afresh where they are missing (a JAX-package checkpoint):
        count and cursor 0, no tracks of new boxes until the next keyframe."""
        self.last_text_rows = int(z["tf_last_text_rows"]) if "tf_last_text_rows" in z else 0
        self._imm_rr = int(z["tf_imm_rr"]) if "tf_imm_rr" in z else 0
        self._klt = None
        if "tf_klt_host_kid" not in z:
            return
        dev = self.device
        packed = torch.as_tensor(z["tf_klt_prev_pyr"], dtype=torch.float32, device=dev)
        st = {"host_kid": int(z["tf_klt_host_kid"]),
              "prev_pyr": (packed, z["tf_klt_prev_shapes"].copy())}
        if int(z["tf_klt_last_frame_id"]) >= 0:
            st["last_frame_id"] = int(z["tf_klt_last_frame_id"])
        for key, name in _KLT_HOST.items():
            st[name] = z[f"tf_klt_{key}"].copy()
        for key, name in _KLT_DEV.items():
            st[name] = torch.as_tensor(z[f"tf_klt_{key}"], device=dev)
        self._klt = st

    def _theta_from_klt(self, kid: int, quad: np.ndarray):
        """theta from KLT tracks of the box between this KF and its latest
        pyramid-bearing neighbour in the last 6 KFs."""
        from ..geometry import triangulate as tri

        m = self.map
        cam = self.cfg.camera
        dev = self.device
        others = [k for k in m.window_kfs(6) if k != kid and self._kf_has_pyr(k)]
        if not others or not self._kf_has_pyr(kid):
            return None
        other = others[-1]
        kf_i, kf_j = m.keyframes[kid], m.keyframes[other]
        pi, gi = self._unpack_pyr(m.kf_pyr_dev(kf_i), kf_i.pyr_shapes)
        pj, _ = self._unpack_pyr(m.kf_pyr_dev(kf_j), kf_j.pyr_shapes)
        q = _f32(quad, dev)
        mu, sigma, _ = rasterize.quad_stats(pi[0], q)
        uv, _, fvalid = extract_text_features(pi[0], gi[0], q, mu, sigma,
                                              self.cfg.text.max_features_per_level)
        uv_j, ok = klt.klt_track(pi, gi, pj, uv, fvalid, levels=(3, 2, 1, 0))
        T_i, T_j = _f32(m.kf_pose[kid], dev), _f32(m.kf_pose[other], dev)
        P_w = tri.triangulate(unproject(uv, cam.fx, cam.fy, cam.cx, cam.cy),
                              unproject(uv_j, cam.fx, cam.fy, cam.cx, cam.cy), T_i, T_j)
        pk = torch.cat([ok[:, None].float(), se3.apply(T_i, P_w),
                        tri.reproj_err2(P_w, T_j, uv_j, cam.fx, cam.fy, cam.cx, cam.cy)[:, None]],
                       dim=1).cpu().numpy()  # one readback
        ok_np = pk[:, 0] > 0.5
        if ok_np.sum() < 5:
            return None
        p_i, e_j = pk[:, 1:4], pk[:, 4]
        good = ok_np & (p_i[:, 2] > 0.05) & (e_j < 4.0)
        if good.sum() < 5:
            return None
        theta, ok2 = self._theta_ransac(*self._constraints(p_i, good))
        return theta if ok2 else None

    # ------------------------------------------------------------------
    # per-frame KLT tracks of new text (TrackNewTextFeat / InitialTextObjs)
    def seed_new_text_tracks(self, kid: int):
        """Seed KLT tracks for this KF's still-unmapped detections."""
        m = self.map
        kf = m.keyframes[kid]
        self._klt = None
        if kf.pyr_shapes is None or not kf.det_text:
            return
        boxes = [d for d in range(len(kf.det_text)) if kf.det_object[d] < 0]
        if not boxes:
            return
        F = self.cfg.text.max_features_per_level
        dev = self.device
        prev_pyr = (m.kf_pyr_dev(kf), kf.pyr_shapes)
        imgs, grads = self._unpack_pyr(*prev_pyr)
        D = len(boxes)
        Dp = pad_tier(D, 4)
        quads = np.zeros((Dp, 4, 2), np.float32)
        for i, d in enumerate(boxes):
            quads[i] = kf.det_text[d].quad
        packed = _seed_features(imgs[0], grads[0], _f32(quads, dev), F).cpu().numpy()
        uv_all = packed[: Dp * F * 2].reshape(Dp, F, 2)[:D].reshape(D * F, 2)
        val_all = packed[Dp * F * 2:].reshape(Dp, F)[:D].reshape(D * F) > 0.5
        det_all = np.repeat(np.asarray(boxes, np.int32), F)
        # the track state stays on the device between keyframes (padded to a
        # tier); the host reads it once, at the next KF
        M = len(det_all)
        Mp = pad_tier(M, 256)
        uv_p = np.zeros((Mp, 2), np.float32)
        uv_p[:M] = uv_all
        val_p = np.zeros(Mp, bool)
        val_p[:M] = val_all
        self._klt = {
            "host_kid": kid,
            "uv_host": uv_all.copy(),
            "valid": val_all,
            "det_idx": det_all,
            "uv_cur_dev": _f32(uv_p, dev),
            "valid_dev": _bool(val_p, dev),
            # the packed pyramid of the frame the tracks were last advanced on
            # and its level shapes (a checkpoint saves it)
            "prev_pyr": prev_pyr,
        }

    def track_new_text(self, frame):
        """Advance the new-text KLT tracks one frame, on the device; tracks
        that fail drop out for good."""
        st = self._klt
        if st is None or frame.pyr_shapes is None:
            return
        if st.get("last_frame_id") == frame.frame_id:
            return  # already advanced for this frame (the chain's retry)
        st["last_frame_id"] = frame.frame_id
        imgs_j, _ = self._unpack_pyr(frame.pyr_dev, frame.pyr_shapes)
        imgs_i, grads_i = self._unpack_pyr(*st["prev_pyr"])
        uv_j, ok = klt.klt_track(imgs_i, grads_i, imgs_j,
                                 st["uv_cur_dev"], st["valid_dev"], levels=(3, 2, 1, 0))
        st["uv_cur_dev"] = uv_j
        st["valid_dev"] = st["valid_dev"] & ok
        st["prev_pyr"] = (frame.pyr_dev, frame.pyr_shapes)

    def create_from_tracks(self, new_kid: int):
        """At KF time, triangulate the accumulated tracks of the previous
        KF's unmapped boxes against the new KF and solve theta; objects are
        hosted at the previous KF, IMMATURE."""
        from ..geometry import triangulate as tri

        st = self._klt
        m = self.map
        cam = self.cfg.camera
        dev = self.device
        if st is None or st["host_kid"] == new_kid:
            return []
        M = len(st["det_idx"])
        packed = torch.cat([st["uv_cur_dev"], st["valid_dev"][:, None].float()],
                           dim=1).cpu().numpy()  # one readback of the track state
        uv_cur = packed[:M, :2]
        valid = st["valid"] & (packed[:M, 2] > 0.5)
        host = st["host_kid"]
        kf_h = m.keyframes[host]
        T_h, T_c = _f32(m.kf_pose[host], dev), _f32(m.kf_pose[new_kid], dev)
        created = []
        for d in np.unique(st["det_idx"]):
            d = int(d)
            if kf_h.det_object[d] >= 0:
                continue  # mapped by another path meanwhile
            if m.n_texts >= self.cfg.text.max_objects:
                break
            sel = (st["det_idx"] == d) & valid
            if int(sel.sum()) < 5:
                continue
            uv_c = _f32(uv_cur[sel], dev)
            P_w = tri.triangulate(
                unproject(_f32(st["uv_host"][sel], dev), cam.fx, cam.fy, cam.cx, cam.cy),
                unproject(uv_c, cam.fx, cam.fy, cam.cx, cam.cy), T_h, T_c)
            pk = torch.cat([se3.apply(T_h, P_w),
                            tri.reproj_err2(P_w, T_c, uv_c, cam.fx, cam.fy, cam.cx,
                                            cam.cy)[:, None]], dim=1).cpu().numpy()
            p_h, e_c = pk[:, :3], pk[:, 3]
            good = (p_h[:, 2] > 0.05) & (e_c < 4.0)
            if int(good.sum()) < 5:
                continue
            theta, ok2 = self._theta_ransac(*self._constraints(p_h, good))
            if not ok2 or not np.isfinite(theta).all():
                continue
            det = kf_h.det_text[d]
            tid = m.add_text(host, theta, det.quad, det.text, det.score, det.lang,
                             state=TEXT_IMMATURE)
            if tid < 0:
                continue  # pool saturated (logged + counted by the map)
            self._extract_reference(tid)
            m.add_text_observation(host, tid, d)
            self._fuse_semantic(tid, det, host)
            created.append(tid)
        return created

    def _extract_reference(self, tid: int):
        """Per-level reference features + level-0 box pixels for the ZNCC
        gate of a new object: one device pass, one readback."""
        m = self.map
        kf = m.keyframes[int(m.tx_host[tid])]
        if kf.pyr_shapes is None:
            return
        F = self.cfg.text.max_features_per_level
        L, B = self.n_levels, self.B
        packed = _extract_reference(
            m.kf_pyr_dev(kf), np.asarray(kf.pyr_shapes), _f32(m.tx_quad[tid], self.device),
            n_levels=L, n_feat=F, n_box=B).cpu().numpy()
        o = 0
        parts = []
        for n, shape in ((L * F * 2, (L, F, 2)), (L * F * 8, (L, F, 8)), (L * F, (L, F)),
                         (L * 2, (L, 2)), (B * 2, (B, 2)), (B, (B,)), (B, (B,))):
            parts.append(packed[o: o + n].reshape(shape))
            o += n
        uv, ref, valid, ms, box_uv, box_int, box_valid = parts
        m.tx_feat_uv[tid] = uv
        m.tx_feat_ref[tid] = ref
        m.tx_feat_valid[tid] = valid > 0.5
        self.tx_host_stats[tid] = ms
        self.tx_box_uv[tid] = box_uv
        self.tx_box_int[tid] = box_int
        self.tx_box_valid[tid] = box_valid > 0.5
        self._pool_version += 1  # invalidates the device pool cache

    # ------------------------------------------------------------------
    # geometry helpers (host numpy: these run inside per-object loops)
    def _quad_world(self, tid: int) -> np.ndarray:
        """Text quad corners as world points through theta."""
        m = self.map
        cam = self.cfg.camera
        rays = se3_np.unproject(m.tx_quad[tid], cam.fx, cam.fy, cam.cx, cam.cy)
        rho = -(rays * m.tx_theta[tid]).sum(-1)
        p_r = rays / rho[:, None].clip(1e-12)
        return se3_np.apply(se3_np.inverse(m.kf_pose[int(m.tx_host[tid])]), p_r)

    def _pool_rows(self, Tt: int):
        """Padded text-pool rows [Tt]: quads, thetas (benign placeholder
        planes), host poses (identity), live, GOOD."""
        m = self.map
        n = m.n_texts
        quads = np.zeros((Tt, 4, 2), np.float32)
        thetas = np.zeros((Tt, 3), np.float32)
        thetas[:, 2] = -1.0
        hposes = np.zeros((Tt, 7), np.float32)
        hposes[:, 0] = 1.0
        live = np.zeros(Tt, bool)
        good = np.zeros(Tt, bool)
        quads[:n] = m.tx_quad[:n]
        thetas[:n] = m.tx_theta[:n]
        hposes[:n] = m.kf_pose[m.tx_host[:n].clip(0)]
        live[:n] = m.tx_valid[:n] & (m.tx_state[:n] != TEXT_BAD)
        if self.pool_mask_hook is not None:
            live[:n] &= self.pool_mask_hook(n)
        good[:n] = m.tx_state[:n] == TEXT_GOOD
        dev = self.device
        return (_f32(quads, dev), _f32(thetas, dev), _f32(hposes, dev), _bool(live, dev),
                _bool(good, dev))

    def _pool_gates(self, pose_cw: np.ndarray, img0: torch.Tensor):
        """The TextJudge gates of the live pool at a pose, with the ZNCC
        against the level-0 image img0: (geo, full), [n_texts] bool each."""
        m = self.map
        cam = self.cfg.camera
        Tt = pad_tier(max(m.n_texts, 1), 8)
        quads, thetas, hposes, live, _ = self._pool_rows(Tt)
        box_uv, box_int, box_valid = self._pool_dev(Tt)[:3]
        geo, full, _ = _gates(
            _f32(pose_cw, self.device), quads, thetas, hposes, live, box_uv, box_int, box_valid,
            img0, cam.fx, cam.fy, cam.cx, cam.cy, self.cfg.text.in_image_margin,
            self.cfg.text.cos_orientation_min, self.cfg.text.zncc_min, cam.width, cam.height)
        both = torch.stack([geo, full]).cpu().numpy()[:, : m.n_texts]
        return both[0], both[1]

    def _gates_geo(self, pose_cw: np.ndarray) -> np.ndarray:
        """Geometric gate (orientation + box in image) of the live pool at
        a pose, without the appearance gate: [n_texts] bool."""
        return self._pool_gates(pose_cw, torch.zeros((8, 8), device=self.device))[0]

    def visible_texts(self, pose_cw: np.ndarray, frame, states=(TEXT_GOOD,)) -> List[int]:
        """Ids of the objects in `states` that pass the TextJudge gates at
        pose_cw: orientation and box in image, and with a frame also the
        ZNCC against its level-0 image (a frame without a pyramid fails
        it)."""
        m = self.map
        if frame is not None and frame.pyr_shapes is not None:
            h, w = int(frame.pyr_shapes[0][0]), int(frame.pyr_shapes[0][1])
            pyr = (frame.pyr_dev if frame.pyr_dev is not None
                   else _f32(frame.pyr_data, self.device))
            img0 = pyr[0, :h, :w, 0]
        else:
            img0 = torch.zeros((8, 8), device=self.device)
        geo, full = self._pool_gates(pose_cw, img0)
        mask = full if frame is not None else geo
        return [t for t in range(m.n_texts) if mask[t] and m.tx_state[t] in states]

    # ------------------------------------------------------------------
    # the windowed BA's text inputs
    def ba_text_batches(self, window_kids, slot, K):
        """Pairs (GOOD text, window KF observing it) of the windowed BA and
        the compact theta pool. The host pose joins as a free block if in
        the window, else frozen. Returns (pairs dict, tids, tid_to_lm) or
        None."""
        m = self.map
        pairs_t, tgt_slots, host_slots, hiw, hposes, tposes, tgt_kids = ([] for _ in range(7))
        for kid in window_kids:
            for tid in list(m.tx_obs_by_kid.get(kid, {})):
                if not m.tx_valid[tid] or m.tx_state[tid] != TEXT_GOOD:
                    continue
                if not m.tx_obs_good.get((kid, tid), True):
                    continue  # a gated-out observation stays out
                h = int(m.tx_host[tid])
                if h == kid:
                    continue  # the host frame's residual is identically zero
                if not self._kf_has_pyr(kid):
                    continue
                pairs_t.append(tid)
                tgt_slots.append(slot[kid])
                host_slots.append(slot.get(h, K))
                hiw.append(h in slot)
                hposes.append(m.kf_pose[h])
                tposes.append(m.kf_pose[kid])
                tgt_kids.append(kid)
        if not pairs_t:
            return None
        cap = self.cfg.solver.max_text_pairs_ba
        if cap and len(pairs_t) > cap:
            # per-solve pair budget: keep the pairs of the most-observed
            # objects, drops logged
            n_obs = m.tx_good_obs[np.asarray(pairs_t, np.int64)]
            keep = np.sort(np.argsort(-n_obs, kind="stable")[:cap])
            print(f"[ba] text-pair budget keeps {cap}/{len(pairs_t)} "
                  f"(window KF, object) pairs by observation count "
                  f"({len(pairs_t) - cap} dropped)")
            pairs_t, tgt_slots, host_slots, hiw, hposes, tposes, tgt_kids = (
                [lst[i] for i in keep]
                for lst in (pairs_t, tgt_slots, host_slots, hiw, hposes, tposes, tgt_kids))
        tids = sorted(set(pairs_t))
        tid_to_lm = {t: i for i, t in enumerate(tids)}
        return {
            "tids": pairs_t, "target_slots": tgt_slots, "host_slots": host_slots,
            "host_in_window": hiw, "host_poses": hposes, "target_poses": tposes,
            "target_kids": tgt_kids,
        }, tids, tid_to_lm

    def _ba_pair_inputs(self, pairs, tid_to_lm) -> dict:
        """The level-independent text inputs of one windowed BA, uploaded
        once: pair arrays padded to [Np] (pair_quads, pair_lm, pair_tgt,
        pair_host, pair_hiw, pair_hpose) and row arrays padded to
        [O = Np*F] (rows: tgt, host, hp, hiw, text)."""
        m = self.map
        dev = self.device
        n_pairs = len(pairs["tids"])
        F = self.cfg.text.max_features_per_level
        Np = pad_tier(n_pairs, 32)
        O = Np * F
        O_real = n_pairs * F
        tids_np = np.asarray(pairs["tids"], np.int64)
        quads_p = _pad_rows(m.tx_quad[tids_np], Np)
        lm_p = _pad_rows(np.asarray([tid_to_lm[t] for t in pairs["tids"]], np.int64), Np)
        tgt_p = _pad_rows(np.asarray(pairs["target_slots"], np.int64), Np)
        host_p = _pad_rows(np.asarray(pairs["host_slots"], np.int64), Np)
        hiw_p = _pad_rows(np.asarray(pairs["host_in_window"], bool), Np, False)
        hpose = np.asarray(pairs["host_poses"], np.float32)
        hpose_p = _pad_rows(hpose, Np)
        hpose_p[n_pairs:, 0] = 1.0
        hp_rows = _pad_rows(np.repeat(hpose, F, axis=0), O)
        hp_rows[O_real:, 0] = 1.0
        rows = dict(
            tgt=_i64(_pad_rows(np.repeat(tgt_p[:n_pairs], F), O), dev),
            host=_i64(_pad_rows(np.repeat(host_p[:n_pairs], F), O), dev),
            hp=_f32(hp_rows, dev),
            hiw=_bool(_pad_rows(np.repeat(hiw_p[:n_pairs], F), O, False), dev),
            text=_i64(_pad_rows(np.repeat(lm_p[:n_pairs], F), O), dev),
        )
        return dict(rows=rows, pair_quads=_f32(quads_p, dev), pair_lm=_i64(lm_p, dev),
                    pair_tgt=_i64(tgt_p, dev), pair_host=_i64(host_p, dev),
                    pair_hiw=_bool(hiw_p, dev), pair_hpose=_f32(hpose_p, dev),
                    n_pairs=n_pairs, Np=Np)

    def _ba_level_inputs(self, pairs, level: int, Np: int):
        """One level's feature inputs of the windowed BA: (feat_uv [Np, F,
        2] level px, ref [O, 8], fvalid [O]); a feature that failed the chi2
        gate at its target KF stays out."""
        m = self.map
        dev = self.device
        F = self.cfg.text.max_features_per_level
        O = Np * F
        tids_np = np.asarray(pairs["tids"], np.int64)
        O_real = len(tids_np) * F
        fvalid = m.tx_feat_valid[tids_np, level].copy()
        for i, (tid, k) in enumerate(zip(pairs["tids"], pairs["target_kids"])):
            fg = m.tx_feat_good.get((k, tid))
            if fg is not None:
                fvalid[i] &= fg[level]
        return (_f32(_pad_rows(m.tx_feat_uv[tids_np, level], Np), dev),
                _f32(_pad_rows(m.tx_feat_ref[tids_np, level].reshape(O_real, 8), O), dev),
                _bool(_pad_rows(fvalid.reshape(O_real), O, False), dev))

    def fused_ba_inputs(self, pairs, tid_to_lm, window_kids, levels, K_pad):
        """Host-side packing of fused_ba_schedule's text inputs for every
        level. Returns a dict, or None when no window KF has a pyramid.
        Pair arrays are padded to [Np], row arrays to [O = Np*F]."""
        imgs_lv = self.gather_level_images(window_kids, levels, K_pad)
        if imgs_lv is None:
            return None
        out = self._ba_pair_inputs(pairs, tid_to_lm)
        per_level = [self._ba_level_inputs(pairs, level, out["Np"]) for level in levels]
        feat_uv_lv, ref_lv, fvalid_lv = (tuple(x) for x in zip(*per_level))
        return dict(out, feat_uv_lv=feat_uv_lv, ref_lv=ref_lv, fvalid_lv=fvalid_lv,
                    imgs_lv=imgs_lv)

    def gather_level_images(self, window_kids, levels, K_pad: int):
        """Per level, the [K_pad, H_l, W_l, 3] device stack of the window's
        keyframe pyramids in the layout the region sampler reads (zero slots
        for keyframes without a pyramid and past the window), built once
        per solve; None when no window KF has a pyramid."""
        m = self.map
        ref_kf = next((m.keyframes[k] for k in window_kids
                       if m.keyframes[k].pyr_shapes is not None), None)
        if ref_kf is None:
            return None
        return self._stack_levels([m.kf_pyr_dev(m.keyframes[k]) for k in window_kids],
                                  ref_kf.pyr_shapes, levels, K_pad)

    def build_text_obs(self, pairs, tid_to_lm, prob, level: int, images, weight=None,
                       cache=None):
        """The padded text rows (TextObs) of one pyramid level of a windowed
        BA whose pairs come from ba_text_batches, at the current estimate of
        `prob` (poses, thetas; the mu/sigma recompute of
        src/optimizer.cc:1179-1184, as fused_ba_schedule does), sampling
        the level's stack `images` (from gather_level_images). `cache` is a dict
        the caller keeps for one windowed solve: the level-independent
        inputs (pair geometry and row metadata) are built and uploaded once
        and reused across the coarse-to-fine levels. Rows are laid out as
        in fused_ba_schedule: [Np, F], F = max_features_per_level."""
        c = {} if cache is None else cache
        if "pairs" not in c:
            fi = self._ba_pair_inputs(pairs, tid_to_lm)
            cam = self.cfg.camera
            w = self.cfg.solver.weight_text if weight is None else weight
            fi["qrays"] = unproject(fi["pair_quads"], cam.fx, cam.fy, cam.cx, cam.cy)
            fi["weight_rows"] = torch.full((fi["Np"] * self.cfg.text.max_features_per_level,),
                                           w, device=self.device)
            c["pairs"] = fi
        fi = c["pairs"]
        cam = self.cfg.camera
        feat_uv, ref, fvalid = self._ba_level_inputs(pairs, level, fi["Np"])
        return _level_text_obs(prob, fi["rows"], fi["qrays"], fi["pair_lm"], fi["pair_tgt"],
                               fi["pair_host"], fi["pair_hiw"], fi["pair_hpose"], feat_uv, ref,
                               fvalid, images, level, fi["weight_rows"], cam.fx, cam.fy, cam.cx,
                               cam.cy)

    # ------------------------------------------------------------------
    # tracker hooks
    def on_initialized(self, f1, f2, kid1: int, kid2: int):
        """GOOD text objects from the first keyframe's detections, then the
        second keyframe's detections associated (so the init BA and the
        theta refinement see host -> KF2 observations)."""
        kf1 = self.map.keyframes[kid1]
        for d in range(len(kf1.det_text or [])):
            self.try_create_text(kid1, d, state=TEXT_GOOD)
        self.associate_detections(kid2)
        self.map.rebuild_covis_m23()

    def refine_init_thetas(self, kid1: int, kid2: int):
        """theta-only photometric refinement of the init text objects
        against the second keyframe (run after the scene init BA)."""
        m = self.map
        for tid in range(m.n_texts):
            if not m.tx_valid[tid] or int(m.tx_host[tid]) != kid1:
                continue
            if (kid2, tid) not in m.tx_obs:
                continue
            th, ok = self._theta_optimize(tid, [kid2])
            if ok:
                m.tx_theta[tid] = th

    def associate_detections(self, kid: int):
        """Label-lookup association of a KF's detections to live text
        objects: project each geometrically visible live quad, look up each
        detection's center pixel."""
        m = self.map
        kf = m.keyframes[kid]
        dets = kf.det_text or []
        if not dets:
            return
        pose = m.kf_pose[kid]
        geo = self._gates_geo(pose)
        live = [t for t in range(m.n_texts)
                if geo[t] and m.tx_valid[t] and m.tx_state[t] != TEXT_BAD]
        if not live:
            return
        quads = np.stack([self._project_quad_np(t, pose) for t in live])
        centers = np.stack([d.quad.mean(0) for d in dets])
        Tq = pad_tier(len(live), 8)
        quads_p = np.zeros((Tq, 4, 2), np.float32)
        quads_p[: len(live)] = quads
        qv = np.zeros(Tq, bool)
        qv[: len(live)] = True
        dev = self.device
        lab = rasterize.label_lookup(_f32(quads_p, dev), _bool(qv, dev),
                                     _f32(centers, dev)).cpu().numpy()
        for d, lb in enumerate(lab):
            if 0 <= lb < len(live):
                tid = live[int(lb)]
                m.add_text_observation(kid, tid, d)
                self._fuse_semantic(tid, dets[d], kid)

    def hook_inputs(self, frame) -> dict:
        """The padded text-pool / feature-pool / box / level-image inputs of
        fused_text_frame (after kp_sel, before the intrinsics), once per
        frame. Returns {"args": tuple, "R": packed-row length}."""
        m = self.map
        Tt = pad_tier(max(m.n_texts, 1), 8)
        quads, thetas, hposes, live, good_state = self._pool_rows(Tt)
        fdev = frame.pyr_dev
        sh = frame.pyr_shapes
        img0 = fdev[0, : int(sh[0][0]), : int(sh[0][1]), 0]
        imgs_levels = tuple(fdev[lv, : int(sh[lv][0]), : int(sh[lv][1]), :3]
                            for lv in self.levels)
        args = (quads, thetas, hposes, live, good_state, *self._pool_dev(Tt), imgs_levels, img0)
        return {"args": args, "R": max(Tt, 16)}

    def apply_frame_hook(self, hook, imm_handle) -> np.ndarray:
        """Host half of the chained per-frame text hook: observation
        counters, the text-row count of the sparse-text chi2 relaxation, and
        the IMMATURE state machine. Returns the text-refined pose."""
        m = self.map
        pose2, geo, full, text_rows = hook
        self.last_text_rows = text_rows
        m.tx_good_obs[: len(geo)][geo & full] += 1
        m.tx_bad_obs[: len(geo)][geo & ~full] += 1
        with phase("track.immature"):
            self.apply_immature(imm_handle, geo)
        return pose2

    def on_keyframe(self, frame, kid: int):
        m = self.map
        kf = m.keyframes[kid]
        dets = kf.det_text or []
        # 1) the previous KF's unmapped boxes from their multi-frame tracks
        self.create_from_tracks(kid)
        if dets:
            self.associate_detections(kid)
            # 2) new objects from unassociated detections (scene-point theta)
            for d in range(len(dets)):
                if kf.det_object[d] < 0:
                    self.try_create_text(kid, d, state=TEXT_IMMATURE)
        # 3) semantic demotion counters (M2/M3 update at registration)
        self._semantic_conditions()
        # 4) fresh KLT tracks for boxes that remain unmapped
        self.seed_new_text_tracks(kid)

    def _project_quad_np(self, tid: int, pose_cw) -> np.ndarray:
        cam = self.cfg.camera
        pc = se3_np.apply(pose_cw.astype(np.float32), self._quad_world(tid))
        return se3_np.project(pc, cam.fx, cam.fy, cam.cx, cam.cy)

    def _s_geo(self, tid: int, kid: int) -> float:
        """S_geo = (1 + cos) * w_view + d: cos between the observing
        camera's optical axis and the unit world plane normal, d the distance
        from the camera center to the box center. Smaller is better."""
        m = self.map
        Twc = se3_np.inverse(m.kf_pose[kid])
        z_cam = se3_np.qto_matrix(Twc[:4])[:, 2]
        d = float(np.linalg.norm(self._quad_world(tid).mean(0) - Twc[4:7]))
        T_rw = m.kf_pose[int(m.tx_host[tid])]
        theta = m.tx_theta[tid]
        n_w = se3_np.qrotate(se3_np.qconj(T_rw[:4]), theta)
        n_w = n_w / (float(T_rw[4:7] @ theta) + 1.0)
        n_w = n_w / np.linalg.norm(n_w).clip(1e-12)
        return (1.0 + float(z_cam @ n_w)) * self.cfg.text.sem_weight_view + d

    def _fuse_semantic(self, tid: int, det, kid: int):
        """Semantic fusion: every observation scores S_geo + S_mean with
        S_mean = (1 - recognition score) * w_mean; the object keeps the
        string of the argmin observation."""
        m = self.map
        string = (det.text or "").strip()
        if string in ("", "#"):
            return
        s_sem = self._s_geo(tid, kid) + (1.0 - float(det.score)) * self.cfg.text.sem_weight_mean
        if s_sem < m.tx_sem_score[tid]:
            m.tx_sem_score[tid] = s_sem
            m.tx_string[tid] = string
            m.tx_score[tid] = float(det.score)
            m.tx_lang[tid] = det.lang

    def dispatch_immature(self, frame, pose: np.ndarray, geo: np.ndarray):
        """The batched IMMATURE theta solve of all live IMMATURE objects,
        with the current frame (at `pose`) as an extra target; objects that
        fail this frame's geometric gate `geo` are masked out. Returns a
        handle for apply_immature, or None."""
        m = self.map
        if frame is None or frame.pyr_shapes is None:
            return None
        imm = [tid for tid in range(m.n_texts)
               if m.tx_valid[tid] and m.tx_state[tid] == TEXT_IMMATURE]
        if not imm:
            return None
        budget = self.cfg.text.immature_budget_per_frame
        if budget and len(imm) > budget:
            # round-robin slice so every object still refines regularly
            n_vis = len(imm)
            start = self._imm_rr % n_vis
            self._imm_rr += budget
            imm = (imm + imm)[start:start + budget]
            if (self._imm_rr // budget) % 100 == 1:
                print(f"[text] immature budget binds: {budget}/{n_vis} visible IMMATURE "
                      f"objects refine this frame (round-robin)")
        theta_old = m.tx_theta[np.asarray(imm, np.int64)].copy()
        packed = self._theta_optimize_batch(imm, frame, pose, geo)
        return (imm, theta_old, packed)

    def apply_immature(self, handle, geo):
        """Readback + state machine of the IMMATURE solve. Only objects
        passing this frame's geometric gate count an observation and take
        their new theta; a solver failure demotes to BAD; cos(theta_new,
        theta_old) >= cos_promote with enough frame observations promotes to
        GOOD."""
        m = self.map
        cfg = self.cfg
        if handle is None:
            return
        imm_all, theta_old_all, packed_dev = handle
        packed = packed_dev.cpu().numpy()  # the one maturation readback
        th_all = packed[: len(imm_all), :3]
        Hs_all = packed[: len(imm_all), 3:].reshape(-1, 3, 3)
        oks_all = np.isfinite(th_all).all(-1) & (np.linalg.norm(th_all, axis=-1) > 1e-6)
        sel = [i for i, tid in enumerate(imm_all) if tid < len(geo) and geo[tid]]
        if not sel:
            return
        imm = [imm_all[i] for i in sel]
        m.tx_num_obvs[np.asarray(imm, np.int64)] += 1
        for i, tid in zip(sel, imm):
            theta_new = th_all[i]
            if not oks_all[i]:
                m.tx_state[tid] = TEXT_BAD  # solver failure demotes for good
                continue
            m.tx_theta[tid] = theta_new
            H = Hs_all[i]
            if np.isfinite(H).all() and np.linalg.det(H) > 1e-12:
                m.tx_cov[tid] = np.linalg.inv(H)
            old = theta_old_all[i]
            cos = float(np.dot(theta_new, old)
                        / (np.linalg.norm(theta_new) * np.linalg.norm(old) + 1e-12))
            if cos >= cfg.text.cos_promote and m.tx_num_obvs[tid] >= cfg.text.min_obs_promote:
                m.tx_state[tid] = TEXT_GOOD

    def _feat_valid_at(self, tid: int, kid: int) -> np.ndarray:
        """[L, F] feature flags of an object's rows at a KF: its valid
        features minus those the chi2 gate flagged there."""
        m = self.map
        fv = m.tx_feat_valid[tid].copy()
        fg = m.tx_feat_good.get((kid, tid))
        if fg is not None:
            fv &= fg
        return fv

    def _stack_levels(self, devs, shapes, levels, n_slots: int):
        """Per-level [n_slots, H_l, W_l, 3] stacks of packed pyramids (zero
        slots for a None entry and past len(devs))."""
        out = []
        for level in levels:
            h, w = int(shapes[level][0]), int(shapes[level][1])
            st = torch.zeros((n_slots, h, w, 3), device=self.device)
            for i, d in enumerate(devs):
                if d is not None:
                    st[i] = d[level, :h, :w, :3]
            out.append(st)
        return tuple(out)

    def _theta_optimize_batch(self, imm, frame, pose: np.ndarray, geo: np.ndarray):
        """One batched solve of all IMMATURE objects' thetas
        (fused_theta_optimize_all). Targets: each object's observing KFs
        (pyramid-bearing, not its host; the last theta_kf_cap - 1 of them)
        and the current frame. Returns a device [N, 12] tensor (theta 3 |
        H 9) aligned with `imm`."""
        m = self.map
        cam = self.cfg.camera
        scfg = self.cfg.solver
        dev = self.device
        Kt_cap = self.cfg.text.theta_kf_cap
        img_of = {}  # kid -> stack index; -1 = the current frame
        tgt_lists = []
        n_capped = n_dropped = 0
        for tid in imm:
            host_kid = int(m.tx_host[tid])
            kfs = [k for k in m.kfs_observing_text(tid) if k != host_kid and self._kf_has_pyr(k)]
            if Kt_cap and len(kfs) > Kt_cap - 1:
                n_capped += 1
                n_dropped += len(kfs) - (Kt_cap - 1)
                kfs = kfs[-(Kt_cap - 1):]
            for k in kfs:
                img_of.setdefault(k, len(img_of))
            tgt_lists.append(kfs)
        if n_capped:
            print(f"[text] theta_kf_cap={Kt_cap} binds: {n_capped}/{len(imm)} objects keep "
                  f"last {Kt_cap - 1} observers ({n_dropped} KF observations deferred to the "
                  f"BA/landmark passes)")
        frame_idx = img_of.setdefault(-1, len(img_of))
        N = pad_tier(len(imm), 4)
        Kt = pad_tier(max(len(t) for t in tgt_lists) + 1, 4)
        M = pad_tier(len(img_of), 4)
        L = self.n_levels
        F = self.cfg.text.max_features_per_level
        poses = np.zeros((M, 7), np.float32)
        poses[:, 0] = 1.0
        for k, i in img_of.items():
            poses[i] = pose if k == -1 else m.kf_pose[k]
        tgt_img = np.zeros((N, Kt), np.int64)
        tgt_valid = np.zeros((N, Kt), bool)
        host_poses = np.zeros((N, 7), np.float32)
        host_poses[:, 0] = 1.0
        quads0 = np.zeros((N, 4, 2), np.float32)
        theta0 = np.zeros((N, 3), np.float32)
        theta0[:, 2] = -1.0
        obj_valid = np.zeros(N, bool)
        feat_uv = np.zeros((N, L, F, 2), np.float32)
        feat_ref = np.zeros((N, L, F, 8), np.float32)
        fvk = np.zeros((N, Kt, L, F), bool)
        for i, tid in enumerate(imm):
            kfs = tgt_lists[i]
            tgt_img[i, : len(kfs)] = [img_of[k] for k in kfs]
            tgt_img[i, len(kfs)] = frame_idx
            tgt_valid[i, : len(kfs) + 1] = True
            host_poses[i] = m.kf_pose[int(m.tx_host[tid])]
            quads0[i] = m.tx_quad[tid]
            theta0[i] = m.tx_theta[tid]
            # only objects passing this frame's geometric gate are solved
            obj_valid[i] = tid < len(geo) and bool(geo[tid])
            feat_uv[i] = m.tx_feat_uv[tid]
            feat_ref[i] = m.tx_feat_ref[tid]
            for j, k in enumerate(kfs):
                fvk[i, j] = self._feat_valid_at(tid, k)
            fvk[i, len(kfs)] = m.tx_feat_valid[tid]
        levels = tuple(self.cfg.pyramid.theta_levels)
        devs = [None] * len(img_of)
        for k, i in img_of.items():
            devs[i] = frame.pyr_dev if k == -1 else m.kf_pyr_dev(m.keyframes[k])
        th, H, _ = fused_theta_optimize_all(
            _f32(theta0, dev), _f32(host_poses, dev), _f32(quads0, dev), _f32(poses, dev),
            _i64(tgt_img, dev), _bool(tgt_valid, dev), _bool(obj_valid, dev),
            _f32(feat_uv, dev), _f32(feat_ref, dev), _bool(fvk, dev),
            self._stack_levels(devs, frame.pyr_shapes, levels, M),
            cam.fx, cam.fy, cam.cx, cam.cy, levels=levels, n_iters=scfg.iters_per_level,
            huber_theta=scfg.huber_theta, weight_text=scfg.weight_text)
        return torch.cat([th, H.reshape(N, 9)], dim=1)

    def _theta_optimize(self, tid: int, obs_kfs):
        """theta-only refinement of one object over its observing KFs
        (PyrThetaOptim). Returns (theta [3], ok)."""
        m = self.map
        cam = self.cfg.camera
        scfg = self.cfg.solver
        dev = self.device
        host_kid = int(m.tx_host[tid])
        targets = [k for k in obs_kfs if k != host_kid and self._kf_has_pyr(k)]
        if not targets:
            return m.tx_theta[tid], False
        K = pad_tier(len(targets), 4)
        poses = np.zeros((K, 7), np.float32)
        poses[:, 0] = 1.0
        poses[: len(targets)] = m.kf_pose[targets]
        tgt_valid = np.zeros(K, bool)
        tgt_valid[: len(targets)] = True
        fvk = np.zeros((K, self.n_levels, self.cfg.text.max_features_per_level), bool)
        for i, k in enumerate(targets):
            fvk[i] = self._feat_valid_at(tid, k)
        levels = tuple(self.cfg.pyramid.theta_levels)
        imgs_levels = self._stack_levels([m.kf_pyr_dev(m.keyframes[k]) for k in targets],
                                         m.keyframes[targets[0]].pyr_shapes, levels, K)
        th_t, H_t = fused_theta_optimize(
            _f32(m.tx_theta[tid], dev), _f32(poses, dev), _bool(tgt_valid, dev),
            _f32(m.kf_pose[host_kid], dev), _f32(m.tx_quad[tid], dev),
            _f32(m.tx_feat_uv[tid], dev), _f32(m.tx_feat_ref[tid], dev), _bool(fvk, dev),
            imgs_levels, cam.fx, cam.fy, cam.cx, cam.cy, levels=levels,
            n_iters=scfg.iters_per_level, huber_theta=scfg.huber_theta,
            weight_text=scfg.weight_text)
        pk = torch.cat([th_t, H_t.reshape(9)]).cpu().numpy()
        th, H = pk[:3], pk[3:].reshape(3, 3)
        ok = bool(np.isfinite(th).all()) and np.linalg.norm(th) > 1e-6
        if ok and np.isfinite(H).all() and np.linalg.det(H) > 1e-12:
            m.tx_cov[tid] = np.linalg.inv(H)  # theta covariance
        return th, ok

    def landmark_theta_pass(self) -> int:
        """The theta half of the loop-time landmark-only refinement at
        global-map scale (levels 3..0, iters_landmark, Huber huber_theta, no
        text gate). With every pose fixed the theta blocks decouple, so the
        GOOD objects solve independently, in chunks whose union of observing
        keyframes stays within landmark_chunk_kfs (at most 16 objects each);
        each object uses all its observing keyframes whose observation was
        not gated out. Returns the number of objects refined."""
        m = self.map
        scfg = self.cfg.solver
        tgt_lists = {}
        for tid in range(m.n_texts):
            if not m.tx_valid[tid] or m.tx_state[tid] != TEXT_GOOD:
                continue
            host_kid = int(m.tx_host[tid])
            kfs = [k for k in m.kfs_observing_text(tid)
                   if k != host_kid and self._kf_has_pyr(k) and m.tx_obs_good.get((k, tid), True)]
            if kfs:
                tgt_lists[tid] = kfs
        # host-order grouping: objects hosted near each other share observers
        tids = sorted(tgt_lists, key=lambda t: int(m.tx_host[t]))
        chunks, cur, cur_kfs = [], [], set()
        for tid in tids:
            ks = set(tgt_lists[tid])
            if cur and (len(cur_kfs | ks) > scfg.landmark_chunk_kfs or len(cur) >= 16):
                chunks.append(cur)
                cur, cur_kfs = [], set()
            cur.append(tid)
            cur_kfs |= ks
        if cur:
            chunks.append(cur)
        levels = tuple(self.cfg.pyramid.landmark_levels)
        n_upd = 0
        for chunk in chunks:
            th = self._theta_chunk_solve(chunk, tgt_lists, levels, scfg.iters_landmark,
                                         scfg.huber_theta)
            for i, tid in enumerate(chunk):
                if np.isfinite(th[i]).all() and np.linalg.norm(th[i]) > 1e-6:
                    m.tx_theta[tid] = th[i]
                    n_upd += 1
        if tids:
            log.info("[loop] landmark theta pass: %d/%d objects refined in %d chunks",
                     n_upd, len(tids), len(chunks))
        return n_upd

    def _theta_chunk_solve(self, chunk, tgt_lists, levels, n_iters, huber) -> np.ndarray:
        """One chunk of independent theta-only solves over all observing KFs
        per object (fused_theta_optimize_all, no current frame). The level
        stacks take each keyframe's resident device pyramid, or else upload
        just the level crop of its host mirror (no LRU upload of whole
        pyramids). Returns thetas [N, 3] aligned with `chunk`."""
        m = self.map
        cam = self.cfg.camera
        scfg = self.cfg.solver
        dev = self.device
        img_of = {}
        for tid in chunk:
            for k in tgt_lists[tid]:
                img_of.setdefault(k, len(img_of))
        N = pad_tier(len(chunk), 4)
        Kt = pad_tier(max(len(tgt_lists[t]) for t in chunk), 4)
        M = pad_tier(len(img_of), 4)
        L = self.n_levels
        F = self.cfg.text.max_features_per_level
        poses = np.zeros((M, 7), np.float32)
        poses[:, 0] = 1.0
        for k, i in img_of.items():
            poses[i] = m.kf_pose[k]
        tgt_img = np.zeros((N, Kt), np.int64)
        tgt_valid = np.zeros((N, Kt), bool)
        host_poses = np.zeros((N, 7), np.float32)
        host_poses[:, 0] = 1.0
        quads0 = np.zeros((N, 4, 2), np.float32)
        theta0 = np.zeros((N, 3), np.float32)
        theta0[:, 2] = -1.0
        obj_valid = np.zeros(N, bool)
        feat_uv = np.zeros((N, L, F, 2), np.float32)
        feat_ref = np.zeros((N, L, F, 8), np.float32)
        fvk = np.zeros((N, Kt, L, F), bool)
        for i, tid in enumerate(chunk):
            kfs = tgt_lists[tid]
            tgt_img[i, : len(kfs)] = [img_of[k] for k in kfs]
            tgt_valid[i, : len(kfs)] = True
            host_poses[i] = m.kf_pose[int(m.tx_host[tid])]
            quads0[i] = m.tx_quad[tid]
            theta0[i] = m.tx_theta[tid]
            obj_valid[i] = True
            feat_uv[i] = m.tx_feat_uv[tid]
            feat_ref[i] = m.tx_feat_ref[tid]
            for j, k in enumerate(kfs):
                fvk[i, j] = self._feat_valid_at(tid, k)
        shapes = m.keyframes[next(iter(img_of))].pyr_shapes
        imgs_levels = []
        for level in levels:
            h, w = int(shapes[level][0]), int(shapes[level][1])
            st = torch.zeros((M, h, w, 3), device=dev)
            for k, i in img_of.items():
                kf = m.keyframes[k]
                if kf.pyr_dev is not None:
                    st[i] = kf.pyr_dev[level, :h, :w, :3]
                elif kf.pyr_data is not None:
                    st[i] = _f32(kf.pyr_data[level, :h, :w, :3], dev)
            imgs_levels.append(st)
        th, _, _ = fused_theta_optimize_all(
            _f32(theta0, dev), _f32(host_poses, dev), _f32(quads0, dev), _f32(poses, dev),
            _i64(tgt_img, dev), _bool(tgt_valid, dev), _bool(obj_valid, dev),
            _f32(feat_uv, dev), _f32(feat_ref, dev), _bool(fvk, dev), tuple(imgs_levels),
            cam.fx, cam.fy, cam.cx, cam.cy, levels=levels, n_iters=n_iters,
            huber_theta=huber, weight_text=scfg.weight_text)
        return th.cpu().numpy()

    def _semantic_conditions(self):
        """Demotion: a GOOD object stays GOOD only while good > 2, good *
        0.9 > bad and bad < 40, checked once the map has more than 5 KFs and
        the object's host KF is at least 5 KFs old."""
        m = self.map
        t = self.cfg.text
        last_kid = len(m.keyframes) - 1
        if last_kid <= t.sem_kf_age:
            return
        for tid in range(m.n_texts):
            if not m.tx_valid[tid] or m.tx_state[tid] != TEXT_GOOD:
                continue
            if int(m.tx_host[tid]) >= last_kid - t.sem_kf_age:
                continue
            good = int(m.tx_good_obs[tid])
            bad = int(m.tx_bad_obs[tid])
            if not (good > t.sem_min_good and good * t.sem_bad_ratio > bad
                    and bad < t.sem_max_bad):
                m.tx_state[tid] = TEXT_BAD


def text_frontend_from_numpy(fields, cfg: TextSLAMConfig, slam_map: SlamMap, tracker, *,
                             device) -> TextFrontend:
    """A port TextFrontend from a JAX TextFrontend's state
    (`vars(jax_frontend)`): the box pools, host statistics, the text-row
    count and the maturation cursor. The KLT accumulator of new boxes
    restarts at the next keyframe (as the JAX checkpoint does); the RANSAC
    generator starts from the config's seed."""
    tf = TextFrontend(cfg, slam_map, tracker, device=device)
    for name in ("tx_box_uv", "tx_box_int", "tx_box_valid", "tx_host_stats"):
        dst = getattr(tf, name)
        src = np.asarray(fields[name])
        if src.shape != dst.shape:
            raise ValueError(f"{name}: shape {src.shape} does not match the config's {dst.shape}")
        dst[...] = src
    tf.last_text_rows = int(fields["last_text_rows"])
    tf._imm_rr = int(fields.get("_imm_rr", 0))
    return tf
