"""Semantic loop closing: text-string detection, Sim3 estimation, map
fusion, pose graph and global refinement. Port of
textslam_tpu/loop/closing.py.

- detect: for every text string the current keyframe observes, batched
  Levenshtein scores against all map strings (ops.levenshtein, one
  wavefront for the whole [Q, T] pair matrix; strings longer than the
  device cap go through the native host routine native.levenshtein_batch);
  a match is kept at
  >= max(2/3 of the query's best, the minimum score); keyframes vote with
  covisibility exclusion through M1/M2/M3; the top candidates by votes.
- compute_sim3: 3D-3D correspondences from descriptor matches between the
  two keyframes (map points, and keypoints inside observed text boxes
  backprojected through their planes; one Hamming kernel launch per
  candidate), Horn RANSAC and the Sim3 refinement (solver.sim3_opt).
- correct: the measured Sim3 propagated to the covisible window, landmark
  fusion (replace_point / replace_text), SearchAndFuse of the loop side's
  points (one Hamming launch per window keyframe) and text objects, the
  Sim3 pose graph, then the scene-only global BA and the landmark-only
  refinement through the tracker.

Host numpy does the bookkeeping; the matching, RANSAC, refinement, pose
graph and BA run on the closer's device. The Sim3 RANSAC draws its 3-point
sets from torch.Generator(seed + 2) (the JAX package keys PRNGKey(seed + 2)
and its stream cannot be reproduced). Progress is logged (logger
`textslam_tpu_torch.loop.closing`), not printed.
"""

from __future__ import annotations

import logging
from typing import List

import numpy as np
import torch

from .. import native
from ..config import TextSLAMConfig
from ..frontend.frame import check_device, desc_to_dev
from ..frontend.tracking import _bool, _f32, _pad, _pad_pose, pad_tier, search_from_3d
from ..geometry import se3, se3_np, sim3
from ..mapper.state import TEXT_BAD, SlamMap
from ..ops import levenshtein, matching, rasterize
from ..solver import sim3_opt
from ..utils.profiling import phase

log = logging.getLogger(__name__)

STOPWORDS = {"", "#", "-", "--"}


class LoopCloser:
    def __init__(self, cfg: TextSLAMConfig, slam_map: SlamMap, *, device):
        self.cfg = cfg
        self.map = slam_map
        self.device = check_device(device, "LoopCloser")
        self.last_loop_kid = -(10 ** 9)
        self.tracker = None  # wired by the system: global BA and text frontend
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 2)
        self.closed_loops = []  # (cur_kid, loop_kid)
        # descriptor searches (one Hamming launch each) of the latest run
        self.n_searches = 0

    def _ransac_sets(self, valid: torch.Tensor) -> torch.Tensor:
        """The [n_sets, 3] index sets of one Sim3 RANSAC."""
        return sim3_opt.ransac_sets(self._gen, valid, self.cfg.loop.sim3_ransac_iters)

    # ------------------------------------------------------------------
    def run(self, kid: int) -> bool:
        """Adaptive word threshold -> detect -> Sim3 over every candidate,
        keeping the best -> accept gates -> correct."""
        m = self.map
        lcfg = self.cfg.loop
        self.n_searches = 0
        if len(m.keyframes) < lcfg.min_kfs_before_loop:
            return False
        if kid - self.last_loop_kid < lcfg.min_kfs_between_loops:
            return False
        thresh, connects, enough = self._thresh_words(kid)
        if not enough:
            return False
        min_words = max(int(np.floor(lcfg.thresh_words_scale * thresh)),
                        self.cfg.loop_thmin_match_words)
        with phase("loop.detect"):
            candidates = self.detect(kid, min_words, connects)
        if not candidates:
            return False
        log.info("[loop] kf %d: %d candidate(s) %s (min_words=%d)", kid, len(candidates),
                 candidates[:5], min_words)

        best = None
        th_scene_sel = self.cfg.loop_th_inliers_scene
        for cand in candidates:
            with phase("loop.compute_sim3"):
                res = self.compute_sim3(kid, cand)
            if res is None:
                continue
            S_cl, pairs, n_inl, n_scene = res
            if th_scene_sel > 0 and n_scene < th_scene_sel:
                continue
            if best is None or n_inl > best[2]:
                best = (cand, S_cl, n_inl, n_scene, pairs)
        if best is None:
            log.info("[loop] kf %d: no candidate passed Sim3", kid)
            return False
        cand, S_cl, n_inl, n_scene, pairs = best
        if n_inl <= lcfg.min_inliers:
            log.info("[loop] kf %d: best cand %d rejected (inliers %d <= %d)", kid, cand,
                     n_inl, lcfg.min_inliers)
            return False
        th_scene_acc = self.cfg.loop_th_max_inlier_scene
        if th_scene_acc > 0 and n_scene < th_scene_acc:
            log.info("[loop] kf %d: best cand %d rejected (scene inliers %d < %d)", kid, cand,
                     n_scene, th_scene_acc)
            return False
        log.info("[loop] kf %d: ACCEPT loop to %d (inliers %d, scene %d)", kid, cand, n_inl,
                 n_scene)
        m.keyframes[kid].loop_edges.append(cand)
        m.keyframes[cand].loop_edges.append(kid)
        self.correct(kid, cand, S_cl, pairs)
        self.last_loop_kid = kid
        self.closed_loops.append((kid, cand))
        return True

    def _thresh_words(self, kid: int):
        """The matched-words threshold: the M2 (shared text objects) count of
        the num_covis_for_thresh-th most M1-covisible KF; more covisible KFs
        than that are needed or no loop is attempted. Also the 2-hop
        covisible KFs not directly covisible with kid (an extra vote
        exclusion when loop_double_check_visible)."""
        m = self.map
        K = len(m.keyframes)
        n_top = self.cfg.loop.num_covis_for_thresh
        order, _ = m.covisible_kfs_sorted(kid)
        if len(order) <= n_top:
            return -1, set(), False
        thresh = int(m.M2[order[:n_top], kid][-1])
        direct = (m.M1[kid, :K] > 0) | (m.M2[kid, :K] > 0) | (m.M3[kid, :K] > 0)
        reach = (m.M1[order][:, :K] > 0).any(axis=0)
        connects = set(np.nonzero(reach & ~direct)[0].tolist()) - {kid}
        return thresh, connects, True

    # ------------------------------------------------------------------
    def detect(self, kid: int, min_words: int, connects=frozenset()) -> List[int]:
        """Text-string loop candidates: one batched Levenshtein for the whole
        [Q, T] pair matrix, then matrix voting."""
        m = self.map
        lcfg = self.cfg.loop
        K = len(m.keyframes)
        dev = self.device

        def usable(s):
            s = (s or "").strip()
            return s not in STOPWORDS and "#" not in s

        cur_tids = [t for (t, _) in m.text_obs_of_kf(kid)
                    if m.tx_valid[t] and usable(m.tx_string[t])]
        if not cur_tids:
            return []
        all_tids = [t for t in range(m.n_texts)
                    if m.tx_valid[t] and m.tx_state[t] != TEXT_BAD and usable(m.tx_string[t])]
        if not all_tids:
            return []
        # full strings are scored: the padded tier follows this call's
        # longest string; above the device cap the host DP takes over
        q_words = [m.tx_string[t] for t in cur_tids]
        t_words = [m.tx_string[t] for t in all_tids]
        maxlen = max(max(len(w) for w in q_words), max(len(w) for w in t_words))
        L = 16
        while L < maxlen:
            L *= 2
        qa, qlen = levenshtein.encode(q_words, L)
        ta, tlen = levenshtein.encode(t_words, L)
        qlen_t = torch.as_tensor(qlen, device=dev)
        tlen_t = torch.as_tensor(tlen, device=dev)
        if L <= lcfg.lev_device_max_len:
            d = levenshtein.levenshtein_matrix(torch.as_tensor(qa, device=dev), qlen_t,
                                               torch.as_tensor(ta, device=dev), tlen_t)
        else:
            d = torch.as_tensor(native.levenshtein_batch(qa, qlen, ta, tlen), device=dev)
        scores = levenshtein.similarity_scores(d, qlen_t, tlen_t).cpu().numpy()

        all_arr = np.asarray(all_tids)
        scores = np.where(all_arr[None, :] == np.asarray(cur_tids)[:, None], -1.0, scores)
        best = scores.max(axis=1)  # [Q]
        # per-query keep threshold: exact matches (1.0) only match exactly;
        # else max(2/3 best, the minimum score); none below min_str_score
        keep = np.where(best >= 1.0, 1.0,
                        np.maximum(best * (2.0 / 3.0), self.cfg.loop_score_thresh))
        keep = np.where(best < lcfg.min_str_score, np.inf, keep)
        match = scores >= keep[:, None]  # [Q, T]

        eligible = np.ones(K, bool)
        eligible[kid] = False
        eligible &= ~((m.M1[kid, :K] > 0) | (m.M2[kid, :K] > 0) | (m.M3[kid, :K] > 0))
        if self.cfg.loop_double_check_visible and connects:
            eligible[np.asarray(sorted(connects), int)] = False
        inc = m.tx_inc[np.asarray(all_tids, np.int64)[:, None],
                       np.arange(K)[None, :]] & eligible[None, :]
        votes = match.sum(axis=0).astype(np.int64) @ inc  # [K]
        distinct = (match.any(axis=0)[:, None] & inc).sum(axis=0)  # [K]

        # by votes, descending: stop at votes <= min_words, skip KFs with
        # <= min_words distinct matched objects, at most top_candidates
        out = []
        for k in np.argsort(-votes, kind="stable"):
            if votes[k] <= min_words:
                break
            if distinct[k] <= min_words:
                continue
            if len(out) >= lcfg.top_candidates:
                break
            out.append(int(k))
        return out

    # ------------------------------------------------------------------
    def compute_sim3(self, kid: int, cand: int):
        """3D-3D correspondences, Sim3 RANSAC and refinement. Returns
        (S_cl [8], {"points": [(pid_cur, pid_loop)], "texts": [(tid_cur,
        tid_loop)]}, refined inliers, scene inliers) or None."""
        m = self.map
        cam = self.cfg.camera
        lcfg = self.cfg.loop
        dev = self.device
        kf_c = m.keyframes[kid]
        kf_l = m.keyframes[cand]

        def kf_3d(kf):
            """Map-point-backed keypoints and their camera-frame points."""
            sel = np.nonzero((kf.kp_point >= 0) & kf.obs_good & kf.kp_valid)[0]
            pids = kf.kp_point[sel]
            ok = m.pt_valid[pids] & ~m.pt_bad[pids]
            sel, pids = sel[ok], pids[ok]
            p_cam = se3_np.apply(m.kf_pose[kf.kid], m.point_world(pids).astype(np.float32))
            return sel, pids, p_cam

        sel_c, pid_c, P_c = kf_3d(kf_c)
        sel_l, pid_l, P_l = kf_3d(kf_l)

        def text_3d(kf):
            """Keypoints inside an observed text box, backprojected through
            the object's plane (theta moved from its host into this KF)."""
            out_sel, out_p, out_tid = [], [], []
            for tid, det_idx in m.tx_obs_by_kid.get(kf.kid, {}).items():
                if not m.tx_valid[tid] or m.tx_state[tid] == TEXT_BAD:
                    continue
                host = int(m.tx_host[tid])
                quad = (m.tx_quad[tid] if host == kf.kid
                        else kf.det_quads[det_idx]
                        if kf.det_quads is not None and det_idx < len(kf.det_quads) else None)
                if quad is None:
                    continue
                sel = np.nonzero(kf.kp_valid)[0]
                inq = rasterize.point_in_quad(_f32(kf.kp_uv[sel], dev), _f32(quad, dev))
                sel = sel[inq.cpu().numpy()]
                if len(sel) == 0:
                    continue
                T_hk = se3_np.relative(m.kf_pose[host], m.kf_pose[kf.kid])
                th = m.tx_theta[tid]
                th_k = se3_np.qrotate(se3_np.qconj(T_hk[:4]), th) / (float(T_hk[4:7] @ th) + 1.0)
                rays = se3_np.unproject(kf.kp_uv[sel], cam.fx, cam.fy, cam.cx, cam.cy)
                rho = -(rays * th_k).sum(-1)
                okz = rho > 1e-4
                out_sel.extend(sel[okz])
                out_p.extend(rays[okz] / rho[okz][:, None])
                out_tid.extend([tid] * int(okz.sum()))
            if not out_sel:
                return np.zeros(0, int), np.zeros((0, 3), np.float32), np.zeros(0, int)
            return np.asarray(out_sel), np.asarray(out_p, np.float32), np.asarray(out_tid)

        tsel_c, tP_c, ttid_c = text_3d(kf_c)
        tsel_l, tP_l, ttid_l = text_3d(kf_l)
        all_sel_c = np.concatenate([sel_c, tsel_c]).astype(int)
        all_P_c = np.concatenate([P_c, tP_c]).astype(np.float32) if len(all_sel_c) else P_c
        all_sel_l = np.concatenate([sel_l, tsel_l]).astype(int)
        all_P_l = np.concatenate([P_l, tP_l]).astype(np.float32) if len(all_sel_l) else P_l
        if len(all_sel_c) < 10 or len(all_sel_l) < 10:
            return None

        # descriptor match between the two sets: one Hamming launch
        N1, N2 = pad_tier(len(all_sel_c)), pad_tier(len(all_sel_l))
        v1 = np.zeros(N1, bool)
        v1[: len(all_sel_c)] = True
        v2 = np.zeros(N2, bool)
        v2[: len(all_sel_l)] = True
        idx, ok = matching.mutual_best_match(
            desc_to_dev(_pad(kf_c.kp_desc[all_sel_c], N1), dev),
            desc_to_dev(_pad(kf_l.kp_desc[all_sel_l], N2), dev),
            _bool(v1, dev), _bool(v2, dev), max_dist=self.cfg.match.th_low)
        self.n_searches += 1
        pk = torch.stack([idx.float(), ok.float()]).cpu().numpy()
        idx, ok = pk[0].astype(np.int64), pk[1] > 0.5
        rows = np.nonzero(ok[: len(all_sel_c)])[0]
        rows = rows[idx[rows] < len(all_sel_l)]
        if len(rows) < 10:
            return None
        Np = pad_tier(len(rows), 64)
        args = (_f32(_pad(all_P_c[rows], Np), dev), _f32(_pad(all_P_l[idx[rows]], Np), dev),
                _f32(_pad(kf_c.kp_uv[all_sel_c[rows]], Np), dev),
                _f32(_pad(kf_l.kp_uv[all_sel_l[idx[rows]]], Np), dev),
                _bool(_pad(np.ones(len(rows), bool), Np, False), dev),
                cam.fx, cam.fy, cam.cx, cam.cy)
        S_cl, _, n_inl = sim3_opt.sim3_ransac_sets(self._ransac_sets(args[4]), *args,
                                                   err2_thresh=lcfg.sim3_inlier_err2)
        if int(n_inl) < lcfg.sim3_min_inliers:
            return None
        S_ref, inl2 = sim3_opt.refine_sim3(S_cl, *args, err_thresh=lcfg.sim3_refine_err,
                                           n_iters=self.cfg.solver.iters_sim3)
        pk = torch.cat([S_ref, inl2.float()]).cpu().numpy()  # one readback
        S_ref, inl_np = pk[:8], pk[8:][: len(rows)] > 0.5
        n2 = int(inl_np.sum())
        # scene-backed inliers (both sides map points), and the fusion pairs
        scene_inl = 0
        fuse_pts, fuse_txts = [], []
        for r, keep in zip(rows, inl_np):
            if not keep:
                continue
            li = idx[r]
            if r < len(sel_c) and li < len(sel_l):
                scene_inl += 1
                fuse_pts.append((int(pid_c[r]), int(pid_l[li])))
            elif r >= len(sel_c) and li >= len(sel_l):
                tc, tl = ttid_c[r - len(sel_c)], ttid_l[li - len(sel_l)]
                if tc != tl:
                    fuse_txts.append((int(tc), int(tl)))
        return S_ref, {"points": fuse_pts, "texts": fuse_txts}, n2, scene_inl

    # ------------------------------------------------------------------
    def correct(self, kid: int, loop_kid: int, S_cl: np.ndarray, pairs):
        """Propagate the measured Sim3 to the covisible window, snapshot the
        previous covisibility, fuse landmarks, SearchAndFuse, build the loop
        edges from the post-fusion covisibility, solve the Sim3 pose graph,
        then the global BA and the landmark-only refinement."""
        m = self.map
        K = len(m.keyframes)
        dev = self.device

        # corrected Sim3 of the current KF, S_cw = S_cl ∘ S_lw, propagated to
        # its M1-covisible window on the new side: S_iw = S_ic ∘ S_cw
        win_ids, _ = m.covisible_kfs_sorted(kid)
        window = {int(w) for w in win_ids} | {kid}
        window = {w for w in window if w > loop_kid}  # the old side stays
        wins = sorted(window)
        S_cw_corr = sim3.compose(_f32(S_cl, dev), sim3.from_se3(_f32(m.kf_pose[loop_kid], dev)))
        S_ic = sim3.from_se3(se3.relative(_f32(m.kf_pose[wins], dev), _f32(m.kf_pose[kid], dev)))
        corr = sim3.compose(S_ic, S_cw_corr[None])
        corr[wins.index(kid)] = S_cw_corr
        corr_np = corr.cpu().numpy()
        corrected = {w: corr_np[i] for i, w in enumerate(wins)}

        # previous covisibility before fusion, for every KF and the loop KF
        norm_conn = {j: m.covisible_prev(j).tolist() for j in range(K)}
        loop_covis = set(int(c) for c in m.covisible_kfs_sorted(loop_kid)[0])

        # landmark fusion: the loop side's landmark survives
        with phase("loop.fuse"):
            for (pc, pl) in pairs["points"]:
                if pc != pl and m.pt_valid[pc] and m.pt_valid[pl]:
                    m.replace_point(pc, pl)
            for (tc, tl) in pairs["texts"]:
                if m.tx_valid[tc] and m.tx_valid[tl]:
                    m.replace_text(tc, tl)
            m.rebuild_covis_m1()
            m.rebuild_covis_m23()
            # SearchAndFuse before the pose graph: loop landmarks project
            # into the window under the corrected poses [R, t/s]; the window
            # KFs' stored poses stay uncorrected until the pose graph
            pose_corr = {w: np.concatenate([S[:4], S[4:7] / max(float(S[7]), 1e-9)])
                         .astype(np.float32) for w, S in corrected.items()}
            self._search_and_fuse(kid, loop_kid, window, pose_corr)
            m.rebuild_covis_m1()
            m.rebuild_covis_m23()

        with phase("loop.pose_graph"):
            # nodes: every KF at s = 1, the window at its corrected Sim3
            # (also the values the loop edges are measured from)
            nodes = sim3.from_se3(_f32(m.kf_pose[:K], dev))
            pre = nodes.clone()
            nodes[wins] = corr
            fixed = np.zeros(K, bool)
            fixed[: min(2, K)] = True
            fixed[loop_kid] = True
            # normal edges: each KF to its previous covisible KFs (pre-fusion),
            # measured from the poses before the correction; loop edges: each
            # window KF to its post-fusion previous covisible KFs that the
            # loop KF saw, measured from the corrected values
            normal = np.asarray([(i, j) for i in range(K) for j in norm_conn[i]],
                                np.int64).reshape(-1, 2)
            loop = np.asarray([(int(i), j) for j in sorted(window | {kid})
                               for i in m.covisible_prev(j) if int(i) in loop_covis],
                              np.int64).reshape(-1, 2)
            meas = [sim3.compose(pre[normal[:, 1]], sim3.inverse(pre[normal[:, 0]])),
                    sim3.compose(nodes[loop[:, 1]], sim3.inverse(nodes[loop[:, 0]]))]
            edge_a = np.concatenate([normal[:, 0], loop[:, 0]])
            edge_b = np.concatenate([normal[:, 1], loop[:, 1]])
            if not len(loop):
                # no post-fusion covisibility between the window and the old
                # side: anchor the measured Sim3 directly
                meas.append(_f32(S_cl, dev)[None])
                edge_a, edge_b = np.r_[edge_a, loop_kid], np.r_[edge_b, kid]
            E = len(edge_a)
            graph = sim3_opt.PoseGraph(
                nodes=nodes, fixed=_bool(fixed, dev),
                edge_a=torch.as_tensor(edge_a, device=dev), edge_b=torch.as_tensor(edge_b, device=dev),
                edge_meas=torch.cat(meas), edge_valid=torch.ones(E, dtype=torch.bool, device=dev),
                edge_weight=torch.ones(E, device=dev))
            out, _ = sim3_opt.solve_pose_graph(graph, n_iters=self.cfg.solver.iters_pose_graph)
            out = out.cpu().numpy()

        # write back T = [R, t/s]; rho and theta scale by their host's s
        scales = out[:, 7].copy()
        m.kf_pose[:K] = np.concatenate(
            [out[:, :4], out[:, 4:7] / np.maximum(scales, np.float32(1e-9))[:, None]], axis=1)
        for valid, host, arr in ((m.pt_valid[: m.n_points], m.pt_host[: m.n_points], m.pt_rho),
                                 (m.tx_valid[: m.n_texts], m.tx_host[: m.n_texts], m.tx_theta)):
            sel = np.nonzero(valid & (host < K))[0]
            s = scales[host[sel]]
            arr[sel] = arr[sel] * (s if arr.ndim == 1 else s[:, None])

        if self.tracker is not None:
            all_kids = list(range(K))
            # scene-only global BA over every keyframe (gauge: KFs 0 and 1)
            with phase("loop.global_ba"):
                self.tracker._local_ba(window_kids=all_kids, fix=[0, 1][: min(2, K)],
                                       scene_only=True)
            # landmark-only refinement; past global_decompose_kfs it splits
            # (exactly: every pose is fixed) into the rho solve and the
            # chunked per-object theta pass
            tf = self.tracker.text_frontend
            decompose = K > self.cfg.solver.global_decompose_kfs and tf is not None
            with phase("loop.landmark_ba"):
                self.tracker._local_ba(window_kids=all_kids, fix=all_kids, landmark_only=True,
                                       scene_only=decompose)
                if decompose:
                    tf.landmark_theta_pass()
        m.rebuild_covis_m1()
        m.rebuild_covis_m23()

    def _loop_landmarks(self, kid: int, loop_kid: int):
        """The loop-side landmarks: the points (not bad) and text objects
        (not BAD) observed by the loop KF and its M1-covisible KFs."""
        m = self.map
        covis, _ = m.covisible_kfs_sorted(loop_kid)
        pts, seen_t, tids = [], set(), []
        for k in [loop_kid] + [int(c) for c in covis]:
            kf = m.keyframes[k]
            pts.append(kf.kp_point[(kf.kp_point >= 0) & kf.kp_valid])
            for t in m.tx_obs_by_kid.get(k, {}):
                if t not in seen_t and m.tx_valid[t] and m.tx_state[t] != TEXT_BAD:
                    seen_t.add(t)
                    tids.append(t)
        pids = np.unique(np.concatenate(pts)) if pts else np.zeros(0, np.int64)
        pids = pids[m.pt_valid[pids] & ~m.pt_bad[pids]]
        return pids, tids

    def _search_and_fuse(self, kid: int, loop_kid: int, window, pose_corr):
        """Project the loop-side points into each window KF under its
        corrected pose (one Hamming launch per KF); a match to an unbound
        keypoint adds an observation, a match to another live point fuses
        it into the loop point. Then the text objects
        (_search_and_fuse_text). pose_corr: {window kid: [q, t/s]}."""
        m = self.map
        cam = self.cfg.camera
        lcfg = self.cfg.loop
        dev = self.device
        lp, loop_tids = self._loop_landmarks(kid, loop_kid)
        fused = 0
        if len(lp):
            P = pad_tier(len(lp))
            for w in sorted(window):
                kf = m.keyframes[w]
                host = m.pt_host[lp].clip(0)
                # loop points already observed in this KF do not search
                valid = np.zeros(P, bool)
                valid[: len(lp)] = [w not in m.pt_obs.get(int(p), ()) for p in lp]
                idx, ok, _, _ = search_from_3d(
                    _f32(_pad(m.pt_ray[lp], P), dev), _f32(_pad(m.pt_rho[lp], P), dev),
                    _f32(_pad_pose(m.kf_pose[host], P), dev),
                    desc_to_dev(_pad(m.pt_desc_latest[lp], P), dev), _bool(valid, dev),
                    _f32(pose_corr[w], dev), _f32(kf.kp_uv, dev), desc_to_dev(kf.kp_desc, dev),
                    _bool(kf.kp_valid, dev), cam.fx, cam.fy, cam.cx, cam.cy,
                    lcfg.fuse_radius_px, self.cfg.match.th_low, cam.width, cam.height,
                    pt_desc_alt=desc_to_dev(_pad(m.pt_desc_second[lp], P), dev))
                self.n_searches += 1
                pk = torch.stack([idx.float(), ok.float()]).cpu().numpy()
                idx, ok = pk[0].astype(np.int64), pk[1] > 0.5
                for r in np.nonzero(ok[: len(lp)])[0]:
                    pid_loop = int(lp[r])
                    if not m.pt_valid[pid_loop]:
                        continue  # fused into another loop point meanwhile
                    kp = int(idx[r])
                    pid_cur = int(kf.kp_point[kp])
                    if pid_cur < 0:
                        m.add_observation(w, kp, pid_loop)
                    elif pid_cur != pid_loop and m.pt_valid[pid_cur]:
                        m.replace_point(pid_cur, pid_loop)
                        fused += 1
                if fused > lcfg.max_fusions_per_loop:
                    log.warning("[loop] SearchAndFuse fusion budget hit (%d > %d) at window KF "
                                "%d; remaining window KFs skipped", fused,
                                lcfg.max_fusions_per_loop, w)
                    break
        self._search_and_fuse_text(kid, loop_kid, window, pose_corr, loop_tids)

    def _search_and_fuse_text(self, kid: int, loop_kid: int, window, pose_corr,
                              loop_tids) -> int:
        """Per window KF: the loop-side objects' quads projected under the
        corrected pose (all corners in front, at least one in the image)
        label the image, later boxes on top; every object this KF observes
        projects its center under the KF's uncorrected pose, and a center on
        a label fuses the observed object into the labelled loop object.
        Returns the number of fusions."""
        m = self.map
        cam = self.cfg.camera
        dev = self.device
        tf = self.tracker.text_frontend if self.tracker is not None else None
        if tf is None or not loop_tids:
            return 0

        def project_quad(tid, pose):
            pc = se3_np.apply(pose.astype(np.float32), tf._quad_world(tid))
            return se3_np.project(pc, cam.fx, cam.fy, cam.cx, cam.cy), pc[:, 2]

        n_fused = 0
        for w in sorted(window):
            label_tids, label_quads = [], []
            for t in loop_tids:
                if not m.tx_valid[t] or m.tx_state[t] == TEXT_BAD:
                    continue  # fused by an earlier window KF of this closure
                uv, z = project_quad(t, pose_corr[w])
                if not (z > 0.05).all():
                    continue
                in_img = ((uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
                          & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height))
                if not in_img.any():
                    continue
                label_tids.append(t)
                label_quads.append(uv)
            if not label_tids:
                continue
            obs_tids, centers = [], []
            for t in list(m.tx_obs_by_kid.get(w, {})):
                if not m.tx_valid[t]:
                    continue
                uv, z = project_quad(t, m.kf_pose[w])
                if not (z > 0.05).all():
                    continue
                obs_tids.append(t)
                centers.append(uv.mean(0))
            if not obs_tids:
                continue
            Tq = pad_tier(len(label_tids), 8)
            quads_p = np.zeros((Tq, 4, 2), np.float32)
            quads_p[: len(label_tids)] = np.stack(label_quads)
            qv = np.zeros(Tq, bool)
            qv[: len(label_tids)] = True
            lab = rasterize.label_lookup(_f32(quads_p, dev), _bool(qv, dev),
                                         _f32(np.stack(centers), dev)).cpu().numpy()
            for i, t_obs in enumerate(obs_tids):
                lb = int(lab[i])
                if lb < 0 or lb >= len(label_tids):
                    continue
                t_loop = label_tids[lb]
                if t_loop == t_obs or not m.tx_valid[t_obs] or not m.tx_valid[t_loop]:
                    continue
                m.replace_text(t_obs, t_loop)
                n_fused += 1
        return n_fused
