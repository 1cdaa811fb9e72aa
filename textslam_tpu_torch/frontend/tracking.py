"""Frontend tracking: state machine, matching, pose optimization, KF policy.

Port of textslam_tpu/frontend/tracking.py:
- SearchFrom3D -> one projection of the whole point pool + a masked Hamming
  match (ops.matching on the CUDA kernel);
- PoseOptim -> solver.ba with a 1-KF window and chi2 gating rounds; with the
  text frontend on, chained with the joint scene+text pose refinement
  (frontend.text.fused_frame_chain);
- SearchForTriangular + CheckTriangular -> one masked match + batched DLT;
- LocalBundleAdjustment -> solver.ba over the sliding window with frozen
  out-of-window hosts, joint with the photometric text rows
  (frontend.text.fused_ba_schedule) when the text frontend is on;
- the loop closer's global passes through the same _local_ba: the
  scene-only BA over every keyframe and the landmark-only refinement
  (all poses fixed, the OptimizeLandmarker schedule);
- with a device mesh (ParallelConfig.ba_devices > 1, or a Mesh set on
  `Tracker.mesh`), every one of those solves runs the sharded LM
  (parallel.ba_sharded.solve_ba_sharded), level by level with the text
  rows (TextFrontend.build_text_obs) and the deferred text gates.

Host Python does the bookkeeping (numpy map); every crossing to the device
names its dtype (float32 / int64 / bool, descriptors as int32 bits), since
torch.as_tensor keeps numpy's float64 where jnp.asarray gave float32. The
per-frame chain stays on the device and comes back in one packed readback.
Padding tiers are kept from the JAX package so both run on the same shapes;
padded rows are masked and change no result.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import TextSLAMConfig
from ..geometry import se3, se3_np, twoview
from ..geometry import triangulate as tri
from ..geometry.camera import project, unproject, in_image
from ..ops import matching, orb
from ..solver import ba
from ..mapper.state import SlamMap, Keyframe
from ..utils.profiling import phase
from .frame import Frame, check_device, desc_to_dev, ensure_host_kp, packed_kp_dev

# tracking states
NOT_INITIALIZED = 0
OK = 1
LOST = 2

# floor of the padded solver tiers (the JAX package's CPU floor)
SOLVER_TIER_MIN = 2048


def pad_tier(n: int, minimum: int = 256) -> int:
    t = minimum
    while t < n:
        t *= 2
    return t


def _pad(a: np.ndarray, n: int, fill=0):
    if a.shape[0] >= n:
        return a[:n]
    pad_width = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad_width, constant_values=fill)


def budget_select(track_len: np.ndarray, cap: int) -> np.ndarray:
    """Indices of the `cap` observations to keep under the per-KF residual
    budget: longest-tracked points first, ties keeping keypoint order;
    returned sorted."""
    order = np.argsort(-track_len, kind="stable")[:cap]
    return np.sort(order)


def _pad_pose(a: np.ndarray, n: int):
    """Pad pose arrays with identity quaternions (a zero quaternion NaNs
    every downstream rotation)."""
    if a.shape[0] >= n:
        return a[:n]
    out = np.zeros((n, 7), a.dtype)
    out[:, 0] = 1.0
    out[: a.shape[0]] = a
    return out


def _project_points(pt_ray, pt_rho, pt_host_pose, pose_guess, fx, fy, cx, cy):
    """Map-point projection under a pose guess; returns (uv [P,2], z [P])."""
    p_host = pt_ray / pt_rho[:, None].clamp(min=1e-9)
    xyz_w = se3.apply(se3.inverse(pt_host_pose), p_host)
    p_c = se3.apply(pose_guess, xyz_w)
    return project(p_c, fx, fy, cx, cy), p_c[:, 2]


def search_from_3d(
    pt_ray, pt_rho, pt_host_pose, pt_desc, pt_valid,
    pose_guess, kp_uv, kp_desc, kp_valid,
    fx, fy, cx, cy, radius, max_dist, width: int, height: int,
    pt_desc_alt=None,
):
    """Project-all + windowed Hamming match (SearchFrom3D analog); each
    point matches as the min distance over its latest and previous
    observation descriptors."""
    proj, z = _project_points(pt_ray, pt_rho, pt_host_pose, pose_guess, fx, fy, cx, cy)
    vis = pt_valid & (z > 0.05) & in_image(proj, width, height, margin=1.0)
    pair = matching.window_mask(proj, kp_uv, radius)
    idx, ok = matching.mutual_best_match(
        pt_desc, kp_desc, vis, kp_valid, pair_mask=pair, max_dist=max_dist,
        d1_alt=pt_desc_alt,
    )
    return idx, ok, proj, z


def _match_triangulate(
    kp_uv1, kp_desc1, kp_valid1, kp_level1,
    kp_uv2, kp_desc2, kp_valid2,
    T1, T2, fx, fy, cx, cy, radius_base, max_dist, max_err2,
    kp_angle1=None, kp_angle2=None, rot_bins: int = 0,
):
    """Match unmatched features between two keyframes and triangulate. The
    window radius scales with the octave of the first keypoint
    (80 * 1.2^level); rot_bins > 0 applies the rotation-consistency filter."""
    radius = radius_base * (1.2 ** kp_level1.float())
    pair = matching.window_mask(kp_uv1, kp_uv2, radius)
    idx, ok = matching.mutual_best_match(
        kp_desc1, kp_desc2, kp_valid1, kp_valid2, pair_mask=pair,
        max_dist=max_dist, ratio=0.9,
    )
    if rot_bins > 0:
        ok = matching.rotation_histogram_filter(kp_angle1, kp_angle2, idx, ok, n_bins=rot_bins)
    ray1 = unproject(kp_uv1, fx, fy, cx, cy)
    ray2 = unproject(kp_uv2[idx], fx, fy, cx, cy)
    P_w = tri.triangulate(ray1, ray2, T1, T2)
    z1 = tri.depths(P_w, T1)
    z2 = tri.depths(P_w, T2)
    e1 = tri.reproj_err2(P_w, T1, kp_uv1, fx, fy, cx, cy)
    e2 = tri.reproj_err2(P_w, T2, kp_uv2[idx], fx, fy, cx, cy)
    good = ok & (z1 > 0.05) & (z2 > 0.05) & (e1 < max_err2) & (e2 < max_err2)
    return idx, good, P_w, z1


def fused_pose_optimize(prob: ba.BAProblem, base_valid, weight_scene,
                        rounds: int, n_iters: int, huber: float, chi2_gate: float):
    """PoseOptim with its chi2 gating rounds: solve, evaluate, re-flag
    outliers, solve again. Each round re-gates against the ORIGINAL
    validity. Returns (pose [7], inlier [O])."""
    inlier = base_valid
    for _ in range(rounds):
        st = ba.solve_ba(prob, n_iters=n_iters, huber_scene=huber)
        prob = prob._replace(poses=st.poses)
        chi2, _ = ba.scene_chi2(prob, huber)
        inlier = base_valid & (chi2 / (weight_scene ** 2) < chi2_gate)
        prob = prob._replace(scene=prob.scene._replace(valid=inlier))
    return prob.poses[0], inlier


def fused_track_step(
    pt_ray, pt_rho_pool, pt_host_pose, pt_desc, pt_desc_alt, pt_valid,
    guess, kp_packed,
    fx, fy, cx, cy, radius, max_dist, weight_scene,
    width: int, height: int, rounds: int, n_iters: int, huber: float,
    chi2_gate: float,
):
    """The whole steady-state track step on the device: SearchFrom3D →
    PoseOptim (chi2 rounds) → tight re-association → conditional
    re-optimize → one packed [4, P] float32 result (rows: idx, ok, inlier,
    [pose(7), n_pass1, n_good, better_flag, 0...]) for a single readback.

    pt_* are the padded point-pool columns [P]; pt_rho_pool is the rho pool
    at its cap [Pt]."""
    P = pt_ray.shape[0]
    Pt = pt_rho_pool.shape[0]
    dev = pt_ray.device
    kp_uv = kp_packed[:, 0:2]
    kp_valid = kp_packed[:, 5] > 0.5
    kp_desc = orb.packed_desc(kp_packed)

    def match(pose, r):
        idx, ok, _, _ = search_from_3d(
            pt_ray, pt_rho_pool[:P], pt_host_pose, pt_desc, pt_valid, pose,
            kp_uv, kp_desc, kp_valid, fx, fy, cx, cy, r, max_dist,
            width, height, pt_desc_alt=pt_desc_alt)
        return idx, ok

    def optimize(pose0, idx, ok):
        scene = ba.SceneObs(
            tgt=torch.zeros(P, dtype=torch.int64, device=dev),
            host=torch.ones(P, dtype=torch.int64, device=dev),
            host_frozen_pose=pt_host_pose,
            host_in_window=torch.zeros(P, dtype=torch.bool, device=dev),
            point=torch.arange(P, device=dev).clamp(max=Pt - 1),
            ray=pt_ray,
            uv=kp_uv[idx],
            weight=torch.full((P,), weight_scene, device=dev),
            valid=ok,
        )
        prob = ba.BAProblem(
            poses=pose0[None],
            pose_free=torch.ones(1, dtype=torch.bool, device=dev),
            rho=pt_rho_pool,
            rho_free=torch.zeros(Pt, dtype=torch.bool, device=dev),
            scene=scene, fx=fx, fy=fy, cx=cx, cy=cy,
        )
        return fused_pose_optimize(prob, ok, weight_scene, rounds=rounds, n_iters=n_iters,
                                   huber=huber, chi2_gate=chi2_gate)

    idx1, ok1 = match(guess, radius)
    pose1, inlier1 = optimize(guess, idx1, ok1)
    idx2, ok2 = match(pose1, radius * 0.5)
    better = ok2.sum() > inlier1.sum()
    idx_f = torch.where(better, idx2, idx1)
    ok_f = torch.where(better, ok2, ok1)
    pose2, inlier2 = optimize(pose1, idx_f, ok_f)
    pose_out = torch.where(better, pose2, pose1)
    inlier_out = torch.where(better, inlier2, inlier1)
    row3 = torch.zeros(P, device=dev)
    row3[:7] = pose_out
    row3[7] = ok1.sum()
    row3[8] = (ok_f & inlier_out).sum()
    row3[9] = better.float()
    return torch.stack([idx_f.float(), ok_f.float(), inlier_out.float(), row3])


def _f32(a, dev):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)


def _i64(a, dev):
    return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)


def _bool(a, dev):
    return torch.as_tensor(np.asarray(a), dtype=torch.bool, device=dev)


class Tracker:
    """Synchronous frontend mirroring tracking::Track."""

    def __init__(self, cfg: TextSLAMConfig, slam_map: SlamMap, *, device):
        self.cfg = cfg
        self.map = slam_map
        self.device = check_device(device, "Tracker")
        self.state = NOT_INITIALIZED
        self.last_frame: Optional[Frame] = None
        self.init_frame: Optional[Frame] = None
        self.velocity: Optional[np.ndarray] = None  # T_cur_last
        self.last_kf_frame_id = -1000
        self.last_pose: Optional[np.ndarray] = None
        self.prev_pose: Optional[np.ndarray] = None
        self.n_tracked_last_kf = 0
        self.trajectory = []  # (timestamp, Tcw) per frame
        self.text_frontend = None  # wired by the system when text is on
        self.loop_hook = None  # called with each new keyframe id
        # optional [P]-mask filter of the matching candidates (tests inject
        # drift / amnesia here)
        self.pt_candidate_hook = None
        # device mesh of the windowed / global BA: when set, _local_ba runs
        # the sharded LM (parallel.ba_sharded) instead of the single-device
        # solver
        from ..parallel.mesh import make_mesh

        self.mesh = make_mesh(cfg.parallel.ba_devices, self.device)

    # ------------------------------------------------------------------
    def process(self, frame: Frame) -> bool:
        if self.state == NOT_INITIALIZED:
            ok = self._try_initialize(frame)
        else:
            ok = self._track(frame)
        if ok and frame.pose is not None:
            self.trajectory.append((frame.timestamp, frame.pose.copy()))
        self.last_frame = frame
        return ok

    # ------------------------------------------------------------------
    # initialization
    def _try_initialize(self, frame: Frame) -> bool:
        if self.init_frame is None:
            if frame.n_valid > 100:
                self.init_frame = frame
            return False
        f1, f2 = self.init_frame, frame
        ensure_host_kp(f1)
        ensure_host_kp(f2)
        dev = self.device
        mcfg = self.cfg.match
        uv1, uv2 = _f32(f1.kp_uv, dev), _f32(f2.kp_uv, dev)
        lv1, lv2 = _i64(f1.kp_level, dev), _i64(f2.kp_level, dev)
        # octave-0 wide-window match (SearchForInitializ)
        pair = matching.window_mask(uv1, uv2, mcfg.search_window_init)
        lvl = matching.level_mask(lv1, lv2, 0)
        idx, ok = matching.mutual_best_match(
            desc_to_dev(f1.kp_desc, dev), desc_to_dev(f2.kp_desc, dev),
            _bool(f1.kp_valid, dev), _bool(f2.kp_valid, dev),
            pair_mask=pair & lvl & (lv1 == 0)[:, None],
            max_dist=mcfg.th_low, ratio=mcfg.nn_ratio_init,
        )
        if mcfg.use_rotation_check:
            ok = matching.rotation_histogram_filter(
                _f32(f1.kp_angle, dev), _f32(f2.kp_angle, dev), idx, ok,
                n_bins=mcfg.histo_length)
        idx_h, ok_h = idx.cpu().numpy(), ok.cpu().numpy()
        if int(ok_h.sum()) < 100:
            self.init_frame = frame if frame.n_valid > 100 else None
            return False
        cam = self.cfg.camera
        # jax.random.PRNGKey(cfg.seed) analog: the same seed on every attempt
        gen = torch.Generator(device=dev).manual_seed(self.cfg.seed)
        res = twoview.initialize_two_view(gen, uv1, uv2[idx], ok, cam.fx, cam.fy, cam.cx, cam.cy)
        if not bool(res.success):
            return False
        self._create_initial_map(f1, f2, idx_h, res.is_inlier.cpu().numpy(),
                                 res.T21.cpu().numpy(), res.points.cpu().numpy())
        self.state = OK
        return True

    def _create_initial_map(self, f1: Frame, f2: Frame, idx, inlier, T21, P1):
        """CreatInitialMap: 2 KFs, points hosted in KF0, InitBA, with the
        scale normalized to median depth 1."""
        m = self.map
        med = np.median(P1[inlier][:, 2])
        P1 = P1 / med
        T21 = T21.copy()
        T21[4:] /= med

        kid1 = m.add_keyframe(self._make_keyframe(f1), se3_np.identity())
        kid2 = m.add_keyframe(self._make_keyframe(f2), T21)
        f1.pose = se3_np.identity()
        f2.pose = T21.copy()

        for i in np.nonzero(inlier)[0]:
            z = P1[i, 2]
            if z <= 0.05:
                continue
            pid = m.add_point(kid1, (P1[i] / z).astype(np.float32), 1.0 / z, f1.kp_desc[i])
            if pid < 0:
                continue  # pool saturated (logged + counted by the map)
            m.add_observation(kid1, int(i), pid)
            m.add_observation(kid2, int(idx[i]), pid)
        m.update_covis_on_obs(kid2, m.keyframes[kid2].kp_point)

        # text objects are created before the init BA so their thetas can
        # join it
        tf = self.text_frontend
        if tf is not None:
            tf.on_initialized(f1, f2, kid1, kid2)
        # InitBA: KF2 pose + rho (KF1 pose fixed), then (unless the thetas
        # solved jointly inside it) theta-only refinement against KF2
        self._local_ba(window_kids=[kid1, kid2], fix=[kid1], init_ba=True)
        if tf is not None and not self.cfg.solver.joint_init_ba:
            tf.refine_init_thetas(kid1, kid2)
        f2.pose = m.kf_pose[kid2].copy()
        self.last_pose = f2.pose.copy()
        self.prev_pose = f1.pose.copy()
        self.last_kf_frame_id = f2.frame_id
        self.n_tracked_last_kf = int(np.count_nonzero(inlier))
        self.velocity = se3_np.relative(f2.pose, f1.pose).astype(np.float32)

    def _make_keyframe(self, frame: Frame) -> Keyframe:
        ensure_host_kp(frame)
        n = frame.kp_uv.shape[0]
        return Keyframe(
            kid=-1,
            frame_id=frame.frame_id,
            timestamp=frame.timestamp,
            kp_uv=frame.kp_uv.copy(),
            kp_level=frame.kp_level.copy(),
            kp_angle=frame.kp_angle.copy(),
            kp_desc=frame.kp_desc.copy(),
            kp_valid=frame.kp_valid.copy(),
            kp_point=np.full(n, -1, np.int32),
            obs_good=np.zeros(n, bool),
            pyr_data=frame.pyr_data,
            pyr_shapes=frame.pyr_shapes,
            pyr_dev=frame.pyr_dev,
            det_quads=(np.stack([d.quad for d in frame.detections]) if frame.detections
                       else np.zeros((0, 4, 2), np.float32)),
            det_text=frame.detections,
            det_object=np.full(len(frame.detections), -1, np.int32),
        )

    # ------------------------------------------------------------------
    # steady-state tracking
    def _track(self, frame: Frame) -> bool:
        m = self.map
        if self.velocity is not None:
            guess = se3_np.compose(self.velocity, self.last_pose).astype(np.float32)
        else:
            guess = self.last_pose.copy()
        # with the text frontend on, the whole per-frame device pipeline (track
        # step + text hook) runs chained with one readback
        chain = self.text_frontend is not None and frame.pyr_shapes is not None
        hook = imm_handle = None
        if chain:
            (pose, kp_idx, ok, inlier, n_matches), hook, imm_handle = self._chain_frame(
                frame, guess)
        else:
            with phase("track.step"):
                pose, kp_idx, ok, inlier, n_matches = self._fused_track(frame, guess)
        if n_matches < 10:
            # re-match without the motion model, wider radius
            guess = self.last_pose.copy()
            if chain:
                (pose, kp_idx, ok, inlier, n_matches), hook, imm_handle = self._chain_frame(
                    frame, guess, radius_scale=2.0)
            else:
                with phase("track.step"):
                    pose, kp_idx, ok, inlier, n_matches = self._fused_track(
                        frame, guess, radius_scale=2.0)
        if n_matches < 10:
            self.state = LOST
            frame.pose = guess
            return False

        frame.pose = pose
        pids = np.arange(len(ok))
        good = ok & inlier
        good_pids = pids[good]
        good_kps = kp_idx[good]
        n_good = len(good_pids)
        if n_good < 10:
            self.state = LOST
            return False
        self.state = OK

        # landmark observation counters
        m.pt_good_obs[good_pids] += 1
        m.pt_bad_obs[pids[ok & ~inlier]] += 1

        # the text hook's host half: counters, maturation, refined pose
        if chain:
            frame.pose = self.text_frontend.apply_frame_hook(hook, imm_handle)

        self.prev_pose = self.last_pose
        self.last_pose = frame.pose.copy()
        if self.prev_pose is not None:
            self.velocity = se3_np.relative(self.last_pose, self.prev_pose).astype(np.float32)

        if self._check_new_keyframe(frame.frame_id, n_good):
            self._insert_keyframe(frame, good_pids, good_kps)
        return True

    def _check_new_keyframe(self, frame_id: int, n_good: int) -> bool:
        """KF policy (CheckNewKeyFrame): c1 = frame gap >= fps/2; c2 = matches
        dropped below 90% of the nearest KF's well-observed point count while
        still > 15; c3 = gap >= fps/2 + 5."""
        m = self.map
        gap = frame_id - self.last_kf_frame_id
        c1 = gap >= self.cfg.kf_min_gap
        c3 = gap >= self.cfg.kf_max_gap
        min_obs = 2 if len(m.keyframes) <= 2 else 3
        neigh = m.nearest_kfs(frame_id, 1)
        n_ref = m.tracked_map_points(neigh[0], min_obs) if neigh else self.n_tracked_last_kf
        c2 = (n_good < 0.9 * n_ref) and n_good > 15
        return c1 or c2 or c3

    def _pose_chi2_gate(self) -> float:
        """Scene chi2 gate of per-frame pose optimization, relaxed to
        chi2Mono + 4 while the latest text refinement held fewer than 50
        text rows (always under noText)."""
        scfg = self.cfg.solver
        n_text_rows = self.text_frontend.last_text_rows if self.text_frontend is not None else 0
        return scfg.chi2_mono_pose if n_text_rows >= 50 else scfg.chi2_mono_pose_lowtext

    def _narrow_to_local_map(self, frame: Frame, pt_valid: np.ndarray):
        """Local-map cap: narrow the candidates to points hosted in the
        local_map_kf_cap most-covisible KFs of the nearest KF, plus its loop
        edges. Mutates pt_valid in place and returns it."""
        m = self.map
        near = m.nearest_kfs(frame.frame_id, 1)[0]
        K = len(m.keyframes)
        order = np.argsort(-m.M1[near, :K])
        local = set(order[: self.cfg.map.local_map_kf_cap].tolist()) | {near}
        local.update(m.keyframes[near].loop_edges)
        host_ok = np.isin(m.pt_host[: m.n_points], np.fromiter(local, np.int64))
        pt_valid[: m.n_points] &= host_ok
        return pt_valid

    def _candidate_valid(self, frame: Frame, P: int) -> np.ndarray:
        """Padded [P] candidate mask: live non-bad points, covisibility-
        narrowed once the map outgrows half its pool, then the optional
        pt_candidate_hook."""
        m = self.map
        pt_valid = _pad(m.pt_valid[: m.n_points] & ~m.pt_bad[: m.n_points], P, False)
        if m.n_points > self.cfg.map.max_points // 2 and m.keyframes:
            pt_valid = self._narrow_to_local_map(frame, pt_valid)
        if self.pt_candidate_hook is not None:
            pt_valid = self.pt_candidate_hook(pt_valid)
        return pt_valid

    def _track_step_args(self, frame: Frame, guess: np.ndarray, radius_scale: float = 1.0):
        """Device inputs of fused_track_step: (tensor args, scalar args,
        static kwargs, P)."""
        m = self.map
        cam = self.cfg.camera
        scfg = self.cfg.solver
        dev = self.device
        P = pad_tier(max(m.n_points, 1), minimum=4096)
        pt_valid = self._candidate_valid(frame, P)
        host = _pad(m.pt_host[: m.n_points], P, 0).clip(0)
        # rho pool sized >= the candidate tier
        Pt = max(self.cfg.map.max_points, P)
        arrays = (
            _f32(_pad(m.pt_ray[: m.n_points], P), dev),
            _f32(_pad(m.pt_rho[: m.n_points], Pt), dev),
            _f32(m.kf_pose[host], dev),
            desc_to_dev(_pad(m.pt_desc_latest[: m.n_points], P), dev),
            desc_to_dev(_pad(m.pt_desc_second[: m.n_points], P), dev),
            _bool(pt_valid, dev),
            _f32(guess, dev),
            packed_kp_dev(frame, dev),
        )
        scalars = (
            cam.fx, cam.fy, cam.cx, cam.cy,
            self.cfg.match.search_radius_3d * radius_scale,
            self.cfg.match.th_high,
            scfg.weight_scene,
        )
        kw = dict(width=cam.width, height=cam.height,
                  rounds=2, n_iters=scfg.iters_per_level,
                  huber=scfg.huber_scene_pose,
                  chi2_gate=self._pose_chi2_gate())
        return arrays, scalars, kw, P

    def _fused_track(self, frame: Frame, guess: np.ndarray, radius_scale: float = 1.0):
        """Run fused_track_step and unpack its single readback.

        Returns (pose [7], kp_idx [P], ok [P], inlier [P], n_pass1)."""
        arrays, scalars, kw, P = self._track_step_args(frame, guess, radius_scale)
        out = fused_track_step(*arrays, *scalars, **kw).cpu().numpy()  # the ONE readback
        return (out[3, :7].astype(np.float32), out[0].astype(np.int64), out[1] > 0.5,
                out[2] > 0.5, int(out[3, 7]))

    def _chain_frame(self, frame: Frame, guess: np.ndarray, radius_scale: float = 1.0):
        """Run the chained per-frame pipeline (track step + text hook),
        unpack its one readback, advance the new-text KLT tracks and
        dispatch the IMMATURE maturation solve.

        Returns (track tuple, hook tuple, imm_handle): track = (pose1,
        kp_idx, ok, inlier, n1); hook = (pose2, geo, full, text_rows)."""
        from .text import fused_frame_chain

        tf = self.text_frontend
        m = self.map
        scfg = self.cfg.solver
        tcfg = self.cfg.text
        arrays, scalars, kw, P = self._track_step_args(frame, guess, radius_scale)
        hi = tf.hook_inputs(frame)
        with phase("track.step"):
            out = fused_frame_chain(
                *arrays, *hi["args"], *scalars,
                tcfg.in_image_margin, tcfg.cos_orientation_min, tcfg.zncc_min,
                width=kw["width"], height=kw["height"], rounds=kw["rounds"],
                track_n_iters=kw["n_iters"], chi2_gate=kw["chi2_gate"],
                levels=tuple(tf.levels), n_iters=scfg.iters_per_level,
                huber_scene=scfg.huber_scene_pose, huber_text=scfg.huber_text,
                weight_text=scfg.weight_text,
            ).cpu().numpy()  # THE per-frame readback
        R = hi["R"]
        t = out[: 4 * P].reshape(4, P)
        pose1 = t[3, :7].astype(np.float32)
        h = out[4 * P:].reshape(3, R)
        geo = h[0, : m.n_texts] > 0.5
        # TextUpdate gates by geo only and targets the pre-refine pose
        with phase("track.immature"):
            imm_handle = tf.dispatch_immature(frame, pose1, geo)
        with phase("track.klt"):
            tf.track_new_text(frame)
        track = (pose1, t[0].astype(np.int64), t[1] > 0.5, t[2] > 0.5, int(t[3, 7]))
        hook = (h[2, :7].astype(np.float32), geo, h[1, : m.n_texts] > 0.5, int(h[2, 7]))
        return track, hook, imm_handle

    # ------------------------------------------------------------------
    # keyframe insertion + local BA
    def _insert_keyframe(self, frame: Frame, tracked_pids, tracked_kps):
        m = self.map
        kid = m.add_keyframe(self._make_keyframe(frame), frame.pose)
        if kid < 0:
            # keyframe pool saturated: keep tracking against the existing map
            self.last_kf_frame_id = frame.frame_id
            return
        for pid, ki in zip(tracked_pids, tracked_kps):
            m.add_observation(kid, int(ki), int(pid))
        m.update_covis_on_obs(kid, tracked_pids)

        with phase("kf.triangulate"):
            self._triangulate_new(kid)

        # windowed BA; gauge: fix only the oldest window KF
        window = m.window_kfs(self.cfg.solver.ba_window)
        with phase("kf.local_ba"):
            self._local_ba(window_kids=window, fix=window[:1])
        # observations the BA gate flagged bad demote their points
        m.cull_bad_points(window)
        frame.pose = m.kf_pose[kid].copy()
        self.last_pose = frame.pose.copy()

        self.last_kf_frame_id = frame.frame_id
        self.n_tracked_last_kf = len(tracked_pids)
        if self.text_frontend is not None:
            self.text_frontend.on_keyframe(frame, kid)
        if self.loop_hook is not None:
            self.loop_hook(kid)

    def _triangulate_new(self, kid: int):
        """New map points between this KF and the previous KF."""
        m = self.map
        cam = self.cfg.camera
        if kid == 0:
            return
        dev = self.device
        prev = m.keyframes[kid - 1]
        cur = m.keyframes[kid]
        v1 = prev.kp_valid & (prev.kp_point < 0)
        v2 = cur.kp_valid & (cur.kp_point < 0)
        mcfg = self.cfg.match
        idx, good, P_w, _ = _match_triangulate(
            _f32(prev.kp_uv, dev), desc_to_dev(prev.kp_desc, dev), _bool(v1, dev),
            _i64(prev.kp_level, dev),
            _f32(cur.kp_uv, dev), desc_to_dev(cur.kp_desc, dev), _bool(v2, dev),
            _f32(m.kf_pose[prev.kid], dev), _f32(m.kf_pose[cur.kid], dev),
            cam.fx, cam.fy, cam.cx, cam.cy,
            mcfg.search_window_triangulate, mcfg.th_low, 9.0,
            kp_angle1=_f32(prev.kp_angle, dev), kp_angle2=_f32(cur.kp_angle, dev),
            rot_bins=mcfg.histo_length if mcfg.use_rotation_check else 0,
        )
        # one packed readback (idx, good, P_w) instead of three
        packed = torch.cat([idx[:, None].float(), good[:, None].float(), P_w], dim=1).cpu().numpy()
        idx = packed[:, 0].astype(np.int64)
        good = packed[:, 1] > 0.5
        P_host = se3_np.apply(m.kf_pose[prev.kid], packed[:, 2:5])
        new_pids = []
        for i in np.nonzero(good)[0]:
            z = P_host[i, 2]
            if z <= 0.05:
                continue
            pid = m.add_point(prev.kid, (P_host[i] / z).astype(np.float32), 1.0 / z, prev.kp_desc[i])
            if pid < 0:
                continue  # pool saturated (logged + counted by the map)
            m.add_observation(prev.kid, int(i), pid)
            m.add_observation(cur.kid, int(idx[i]), pid)
            new_pids.append(pid)
        if new_pids:
            m.update_covis_on_obs(cur.kid, np.asarray(new_pids))

    def _solve(self, prob: ba.BAProblem, n_iters: int, huber_scene: float,
               huber_text: float = 3.0, no_free_poses: bool = False) -> ba.LMState:
        """Windowed / global BA solve with the config's LM damping schedule:
        solve_ba, or the sharded LM over the mesh when one is set (which
        does not take the all-poses-fixed shortcut; the camera step is zero
        either way)."""
        scfg = self.cfg.solver
        kw = dict(n_iters=n_iters, huber_scene=huber_scene, huber_text=huber_text,
                  lam0=scfg.lm_lambda_init, lam_up=scfg.lm_lambda_up,
                  lam_down=scfg.lm_lambda_down, lam_min=scfg.lm_min_lambda,
                  lam_max=scfg.lm_max_lambda)
        if self.mesh is not None:
            from ..parallel import ba_sharded

            return ba_sharded.solve_ba_sharded(prob, self.mesh, **kw)
        return ba.solve_ba(prob, no_free_poses=no_free_poses, **kw)

    def _mesh_text_schedule(self, prob, text_part, window_kids, levels, K: int, huber: float,
                            landmark_only: bool, init_ba: bool, gate_on: bool, no_free: bool):
        """The coarse-to-fine joint BA over the mesh, level by level:
        gather the window's level images, build the level's text rows at the
        current estimate, run the sharded LM, and take the deferred text
        gate's errors through the region sampler (ba.text_sample_errors with
        pair_feat=F). Returns (the packed readback in fused_ba_schedule's
        layout, [(level, gate values)]), or (None, []) when no window KF has
        a pyramid."""
        tf = self.text_frontend
        scfg = self.cfg.solver
        F = self.cfg.text.max_features_per_level
        pairs, _, tid_to_lm = text_part
        with phase("ba.gather_imgs"):
            imgs_lv = tf.gather_level_images(window_kids, levels, K)
        if imgs_lv is None:
            return None, []
        cache = {}  # the level-independent text inputs, built once
        cur, gates = prob, []
        for level, imgs in zip(levels, imgs_lv):
            with phase("ba.build_text_obs"):
                tobs = tf.build_text_obs(pairs, tid_to_lm, cur, level, imgs,
                                         weight=1.0 if init_ba else None, cache=cache)
            cur = cur._replace(text=tobs, images=imgs)
            with phase("ba.solve_joint"):
                st = self._solve(
                    cur, n_iters=scfg.iters_landmark if landmark_only else scfg.iters_per_level,
                    huber_scene=huber,
                    huber_text=scfg.huber_theta if landmark_only else scfg.huber_text,
                    no_free_poses=no_free)
            cur = cur._replace(poses=st.poses, rho=st.rho, theta=st.theta)
            if gate_on:
                with phase("ba.gate_text"):
                    err, ok = ba.text_sample_errors(cur, pair_feat=F)
                    gates.append(torch.cat([err, ok.float()], dim=-1).reshape(-1))
        chi2, _ = ba.scene_chi2(cur._replace(text=None, images=None), scfg.huber_scene_pose)
        packed = torch.cat([cur.poses.reshape(-1), cur.rho, chi2, cur.theta.reshape(-1)] + gates)
        return packed.cpu().numpy(), [(lv, g.numel()) for lv, g in zip(levels, gates)]

    def _local_ba(self, window_kids, fix, init_ba: bool = False,
                  scene_only: bool = False, landmark_only: bool = False):
        """Windowed joint BA; hosts outside the window are frozen. The init
        BA (two KFs) runs unweighted with the init Huber, 3 x iters.

        scene_only leaves the text rows out (the loop closer's global BA);
        landmark_only runs the OptimizeLandmarker schedule: all poses fixed
        (the no-free-poses solver path), levels 3..0, iters_landmark per
        level, Huber huber_rho on the rho rows and huber_theta on the theta
        rows, the scene gate at chi2_mono_global, and the text gate only
        with text_outlier_landmark (at chi2_text_landmark)."""
        m = self.map
        cam = self.cfg.camera
        scfg = self.cfg.solver
        dev = self.device
        # K pinned at 32 (>= the padded 20-KF window), as in the JAX package
        K = pad_tier(len(window_kids), minimum=32)

        slot_arr = np.full(self.cfg.map.max_keyframes, K, np.int32)
        for i, k in enumerate(window_kids):
            slot_arr[k] = i
        tgt_a, host_a, hostpose_a, inwin_a, point_a, ray_a, uv_a = [], [], [], [], [], [], []
        kf_of_obs, kp_of_obs = [], []
        for kid in window_kids:
            kf = m.keyframes[kid]
            sel = np.nonzero((kf.kp_point >= 0) & kf.obs_good)[0]
            pids = kf.kp_point[sel]
            keep = ~m.pt_bad[pids]
            sel, pids = sel[keep], pids[keep]
            if len(sel) == 0:
                continue
            cap = self.cfg.map.max_obs_per_kf
            if len(sel) > cap:
                # per-KF residual budget: keep the longest-tracked points
                keep = budget_select(m.pt_n_obs[pids], cap)
                print(f"[ba] KF {kid}: residual budget keeps {cap}/{len(sel)} obs "
                      f"by track length ({len(sel) - cap} dropped)")
                sel, pids = sel[keep], pids[keep]
            hosts = m.pt_host[pids]
            tgt_a.append(np.full(len(sel), slot_arr[kid], np.int32))
            host_a.append(slot_arr[hosts])
            hostpose_a.append(m.kf_pose[hosts])
            inwin_a.append(slot_arr[hosts] < K)
            point_a.append(pids)
            ray_a.append(m.pt_ray[pids])
            uv_a.append(kf.kp_uv[sel])
            kf_of_obs.append(np.full(len(sel), kid, np.int32))
            kp_of_obs.append(sel)
        if not point_a:
            return
        tgt_l, host_l = np.concatenate(tgt_a), np.concatenate(host_a)
        hostpose_l, inwin_l = np.concatenate(hostpose_a), np.concatenate(inwin_a)
        point_l, ray_l, uv_l = np.concatenate(point_a), np.concatenate(ray_a), np.concatenate(uv_a)
        kf_of_obs, kp_of_obs = np.concatenate(kf_of_obs), np.concatenate(kp_of_obs)

        # compact point remap
        upts, pinv = np.unique(point_l, return_inverse=True)
        P = pad_tier(len(upts), SOLVER_TIER_MIN)
        O = pad_tier(len(tgt_l), SOLVER_TIER_MIN)
        valid = np.zeros(O, bool)
        valid[: len(tgt_l)] = True
        # rho free only when its host is in the window
        host_in_window_per_pt = np.isin(m.pt_host[upts], window_kids)
        rho_free = np.zeros(P, bool)
        rho_free[: len(upts)] = host_in_window_per_pt
        scene = ba.SceneObs(
            tgt=_i64(_pad(tgt_l, O), dev),
            host=_i64(_pad(host_l, O, K), dev),
            host_frozen_pose=_f32(_pad_pose(hostpose_l.astype(np.float32), O), dev),
            host_in_window=_bool(_pad(inwin_l, O, False), dev),
            point=_i64(_pad(pinv, O), dev),
            ray=_f32(_pad(ray_l, O), dev),
            uv=_f32(_pad(uv_l, O), dev),
            weight=torch.full((O,), 1.0 if init_ba else scfg.weight_scene, device=dev),
            valid=_bool(valid, dev),
        )
        pose_free = np.zeros(K, bool)
        pose_free[: len(window_kids)] = [k not in fix for k in window_kids]
        prob = ba.BAProblem(
            poses=_f32(_pad_pose(m.kf_pose[np.asarray(window_kids)], K), dev),
            pose_free=_bool(pose_free, dev),
            rho=_f32(_pad(m.pt_rho[upts], P), dev),
            rho_free=_bool(rho_free, dev),
            scene=scene, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
        )
        if landmark_only:
            n_it, huber = scfg.iters_landmark, scfg.huber_rho
        else:
            n_it = scfg.iters_per_level * (3 if init_ba else 2)
            huber = scfg.huber_scene_init if init_ba else scfg.huber_scene_pose
        # all-poses-fixed problems take the no-free-poses solver path
        no_free = not pose_free.any()

        # the photometric text rows (joint point+text BA). The init BA stays
        # scene-only unless joint_init_ba: theta is refined right after it
        # instead (TextFrontend.refine_init_thetas)
        tf = self.text_frontend
        text_part = None
        if tf is not None and not scene_only and (not init_ba or scfg.joint_init_ba):
            text_part = tf.ba_text_batches(window_kids, {k: i for i, k in enumerate(window_kids)}, K)
        fused_inputs = theta_meta = packed = None
        gate_outs = []
        levels = (self.cfg.pyramid.landmark_levels if landmark_only
                  else self.cfg.pyramid.init_ba_levels if init_ba else self.cfg.pyramid.ba_levels)
        F = self.cfg.text.max_features_per_level
        gate_on = text_part is not None and (not landmark_only or scfg.text_outlier_landmark)
        if text_part is not None:
            pairs, tids, tid_to_lm = text_part
            Tn = pad_tier(len(tids), minimum=64)
            theta = np.zeros((Tn, 3), np.float32)
            theta[: len(tids)] = m.tx_theta[tids]
            theta_free = np.zeros(Tn, bool)
            theta_free[: len(tids)] = [int(m.tx_host[t]) in window_kids for t in tids]
            theta_meta = (tids, theta_free)
            prob = prob._replace(theta=_f32(theta, dev), theta_free=_bool(theta_free, dev))
            if self.mesh is None:
                with phase("ba.fused_inputs"):
                    fused_inputs = tf.fused_ba_inputs(pairs, tid_to_lm, window_kids, levels, K)
            else:
                packed, gate_outs = self._mesh_text_schedule(
                    prob, text_part, window_kids, levels, K, huber, landmark_only, init_ba,
                    gate_on, no_free)

        if fused_inputs is not None:
            # the whole coarse-to-fine schedule: per-level pair geometry, LM,
            # text gates, final scene chi2; ONE packed readback
            from .text import fused_ba_schedule

            fi = fused_inputs
            with phase("ba.fused_schedule"):
                packed = fused_ba_schedule(
                    prob, fi["rows"], fi["pair_quads"], fi["pair_lm"], fi["pair_tgt"],
                    fi["pair_host"], fi["pair_hiw"], fi["pair_hpose"], fi["feat_uv_lv"],
                    fi["ref_lv"], fi["fvalid_lv"], fi["imgs_lv"],
                    cam.fx, cam.fy, cam.cx, cam.cy, levels=levels,
                    n_iters=scfg.iters_landmark if landmark_only else scfg.iters_per_level,
                    huber_scene=huber,
                    # theta rows: Huber 2.0 in the landmark pass, 3.0 in the window
                    huber_text=scfg.huber_theta if landmark_only else scfg.huber_text,
                    weight_text=1.0 if init_ba else scfg.weight_text,  # PyrIniBA is unweighted
                    pair_feat=F, gate=gate_on, no_free_poses=no_free,
                    lam0=scfg.lm_lambda_init, lam_up=scfg.lm_lambda_up,
                    lam_down=scfg.lm_lambda_down, lam_min=scfg.lm_min_lambda,
                    lam_max=scfg.lm_max_lambda).cpu().numpy()
            gate_outs = [(lv, fi["Np"] * F * 16) for lv in levels] if gate_on else []
        elif packed is None:
            # no text rows (or no window KF with a pyramid): the scene solve
            with phase("ba.solve_scene"):
                st = self._solve(prob, n_iters=n_it, huber_scene=huber, no_free_poses=no_free)
                chi2, _ = ba.scene_chi2(prob._replace(poses=st.poses, rho=st.rho),
                                        scfg.huber_scene_pose)
                parts = [st.poses.reshape(-1), st.rho, chi2]
                if theta_meta is not None:
                    parts.append(prob.theta.reshape(-1))
                # ONE packed readback: poses, rho, per-observation chi2
                packed = torch.cat(parts).cpu().numpy()

        poses = packed[: K * 7].reshape(K, 7)
        for k, kid in enumerate(window_kids):
            m.kf_pose[kid] = poses[k]
        rho = packed[K * 7: K * 7 + P][: len(upts)]
        m.pt_rho[upts[host_in_window_per_pt]] = rho[host_in_window_per_pt].clip(1e-4, 1e4)
        # chi2 gating -> mark observations bad
        off = K * 7 + P
        O_len = scene.tgt.shape[0]
        chi2_px = packed[off: off + O_len][: len(tgt_l)] / (
            1.0 if init_ba else scfg.weight_scene ** 2)
        off += O_len
        if theta_meta is not None:
            tids, theta_free = theta_meta
            theta = packed[off: off + theta_free.shape[0] * 3].reshape(-1, 3)
            off += theta_free.shape[0] * 3
            for i, t in enumerate(tids):  # thetas of in-window hosts
                if theta_free[i] and np.isfinite(theta[i]).all():
                    m.tx_theta[t] = theta[i]
        for level, n in gate_outs:
            block = packed[off: off + n].reshape(-1, 16)
            self._apply_text_gate(pairs, level, block[: len(pairs["tids"]) * F],
                                  gate=scfg.chi2_text_landmark if landmark_only else None)
            off += n
        # the global and landmark-only passes gate at chi2_mono_global
        all_fixed = landmark_only or len(fix) == len(window_kids)
        gate = scfg.chi2_mono_global if (scene_only or all_fixed) else scfg.chi2_mono_pose
        bad_idx = np.nonzero(chi2_px > gate)[0]
        for kid in np.unique(kf_of_obs[bad_idx]):
            rows = bad_idx[kf_of_obs[bad_idx] == kid]
            m.keyframes[kid].obs_good[kp_of_obs[rows]] = False
        np.add.at(m.pt_bad_obs, point_l[bad_idx], 1)

    def _apply_text_gate(self, pairs, level: int, packed: np.ndarray, gate=None):
        """Host half of the text chi2 gate: packed [n_pairs*F, 16] = (|err| 8 |
        ok 8) rows. A feature observation is bad when any of its 8 normalized
        sample errors exceeds chi2Text[level] (or the flat `gate`); the whole
        (KF, object) observation goes bad when more than text_bad_ratio of
        its features are bad."""
        m = self.map
        scfg = self.cfg.solver
        F = self.cfg.text.max_features_per_level
        n_pairs = len(pairs["tids"])
        err = packed[..., :8].reshape(n_pairs, F, 8)
        ok = packed[..., 8:].reshape(n_pairs, F, 8) > 0.5
        used = ok.any(-1)  # features contributing at this level
        chi = scfg.chi2_text_levels[level] if gate is None else gate
        bad_feat = ((err > chi) & ok).any(-1) & used
        for i, (tid, kid) in enumerate(zip(pairs["tids"], pairs["target_kids"])):
            fg = m.tx_feat_good.get((kid, tid))
            if fg is None:
                continue
            nf = int(used[i].sum())
            if nf == 0:
                continue
            fg[level][bad_feat[i]] = False
            if int(bad_feat[i].sum()) / nf > scfg.text_bad_ratio:
                m.tx_obs_good[(kid, tid)] = False
                m.tx_bad_obs[tid] += 1
