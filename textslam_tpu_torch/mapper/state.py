"""SoA map state: keyframes, scene points, text objects, observations,
covisibility. Port of textslam_tpu/mapper/state.py.

The map is host-side numpy bookkeeping, as in the JAX package: id
allocation, observation registries and the covisibility matrices M1
(#shared points), M2 (#shared text objects) and M3 (#shared level-0 text
features) are O(landmarks) integer work per keyframe, and every device
consumer (matching, BA, the photometric solvers) gathers padded tensors from
these pools. Descriptors stay uint32 on the host (the JAX package's layout);
they become int32 bits on the way to the device. A keyframe's packed
pyramid stays on the device while the keyframe is in the BA window (+8);
older keyframes keep only the host mirror, uploaded again on demand through
a small LRU (kf_pyr_dev).

Loop closing fuses duplicated landmarks (replace_point / replace_text) and
records loop edges on both keyframes. The covisibility rebuilds take the
threaded host product of the native module (native.covis_product; the
weighted M3 product in numpy), or the keyframe-axis-sharded device product
(parallel.covis_sharded) when ParallelConfig.covis_devices > 1 and the map
holds at least covis_min_kfs keyframes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from .. import native
from ..config import TextSLAMConfig

# text object states
TEXT_GOOD = 0
TEXT_IMMATURE = 1
TEXT_BAD = 2


@dataclasses.dataclass
class Keyframe:
    """Host-side per-keyframe record (numpy)."""

    kid: int
    frame_id: int
    timestamp: float
    # ORB features (numpy mirrors of ops.orb.Keypoints)
    kp_uv: np.ndarray  # [N, 2]
    kp_level: np.ndarray  # [N]
    kp_angle: np.ndarray
    kp_desc: np.ndarray  # [N, 8] uint32
    kp_valid: np.ndarray  # [N]
    # observation registry: keypoint index -> point id (-1 = none)
    kp_point: np.ndarray  # [N] int32
    obs_good: np.ndarray  # [N] bool — per-observation good flag (BA gating)
    # packed direct pyramid: host mirror (lazy), true extents, device copy
    pyr_data: Optional[np.ndarray] = None  # [L, H, W, 3] float32
    pyr_shapes: Optional[np.ndarray] = None  # [L, 2] int32
    pyr_dev: Optional[torch.Tensor] = None
    # text detections in this KF
    det_quads: Optional[np.ndarray] = None  # [D, 4, 2] float32 corners
    det_text: Optional[list] = None  # [D] TextDetection records
    det_object: Optional[np.ndarray] = None  # [D] int32 text object id or -1
    # keyframes this one closed a loop with
    loop_edges: List[int] = dataclasses.field(default_factory=list)


class SlamMap:
    """Pool-backed map. Ids are stable array indices."""

    def __init__(self, cfg: TextSLAMConfig, *, device):
        """device: where kf_pyr_dev uploads evicted keyframes' pyramids."""
        self.cfg = cfg
        m = cfg.map
        self.keyframes: List[Keyframe] = []
        self.kf_pose = np.zeros((m.max_keyframes, 7), np.float32)
        self.kf_pose[:, 0] = 1.0
        self.kf_valid = np.zeros(m.max_keyframes, bool)

        # scene points (host ray + inverse depth)
        self.pt_host = np.full(m.max_points, -1, np.int32)
        self.pt_ray = np.zeros((m.max_points, 3), np.float32)
        self.pt_rho = np.zeros(m.max_points, np.float32)
        self.pt_valid = np.zeros(m.max_points, bool)
        self.pt_bad = np.zeros(m.max_points, bool)
        self.pt_desc = np.zeros((m.max_points, 8), np.uint32)
        # viewpoint-adaptive matching descriptors: each point's descriptor as
        # observed in its latest and previous observing keyframe
        self.pt_desc_latest = np.zeros((m.max_points, 8), np.uint32)
        self.pt_desc_second = np.zeros((m.max_points, 8), np.uint32)
        # per-point observation registry pid -> {kid: kp_idx}
        self.pt_obs: Dict[int, Dict[int, int]] = {}
        self.pt_good_obs = np.zeros(m.max_points, np.int32)
        self.pt_bad_obs = np.zeros(m.max_points, np.int32)
        # number of keyframes observing each point
        self.pt_n_obs = np.zeros(m.max_points, np.int32)
        self.n_points = 0

        # text objects (theta in the host KF's frame)
        self.tx_host = np.full(m.max_texts, -1, np.int32)
        self.tx_theta = np.zeros((m.max_texts, 3), np.float32)
        self.tx_state = np.full(m.max_texts, TEXT_BAD, np.int8)
        self.tx_valid = np.zeros(m.max_texts, bool)
        self.tx_quad = np.zeros((m.max_texts, 4, 2), np.float32)  # host-KF px
        self.tx_string: List[str] = ["" for _ in range(m.max_texts)]
        self.tx_score = np.zeros(m.max_texts, np.float32)
        # best (smallest) semantic score so far: S_geo + S_mean, argmin over
        # observations
        self.tx_sem_score = np.full(m.max_texts, np.inf, np.float32)
        self.tx_lang = np.zeros(m.max_texts, np.int8)
        self.tx_good_obs = np.zeros(m.max_texts, np.int32)
        self.tx_bad_obs = np.zeros(m.max_texts, np.int32)
        # IMMATURE maturation counter: +1 per FRAME the object is observable
        self.tx_num_obvs = np.zeros(m.max_texts, np.int32)
        self.tx_cov = np.full((m.max_texts, 3, 3), np.inf, np.float32)
        # per-level reference features: level px + 8 reference intensities
        L = len(cfg.pyramid.theta_levels) + 1
        F = cfg.text.max_features_per_level
        self.tx_feat_uv = np.zeros((m.max_texts, L, F, 2), np.float32)
        self.tx_feat_ref = np.zeros((m.max_texts, L, F, 8), np.float32)
        self.tx_feat_valid = np.zeros((m.max_texts, L, F), bool)
        # text observations (kid, tid) -> detection index, with per-KF and
        # per-object secondary indexes and the dense incidence [T, K]
        self.tx_obs: Dict[tuple, int] = {}
        self.tx_obs_by_kid: Dict[int, Dict[int, int]] = {}
        self.tx_obs_by_tid: Dict[int, Dict[int, int]] = {}
        self.tx_inc = np.zeros((m.max_texts, m.max_keyframes), bool)
        # per-observation good flags and per-feature [L, F] good flags:
        # features that failed the chi2 gate at a KF leave that KF's rows
        self.tx_obs_good: Dict[tuple, bool] = {}
        self.tx_feat_good: Dict[tuple, np.ndarray] = {}
        self.n_texts = 0

        # LRU of device uploads of evicted keyframes' pyramids (kf_pyr_dev)
        self._pyr_lru: Dict[int, torch.Tensor] = {}
        self._pyr_lru_cap = 4
        # the device of pyramid uploads
        self.pyr_device = torch.device(device)

        self.saturation_drops: Dict[str, int] = {"keyframes": 0, "points": 0, "texts": 0}

        # covisibility: #shared points (M1), text objects (M2), level-0
        # text features (M3) between keyframes
        K = m.max_keyframes
        self.M1 = np.zeros((K, K), np.int32)
        self.M2 = np.zeros((K, K), np.int32)
        self.M3 = np.zeros((K, K), np.int32)
        # optional keyframe-axis-sharded rebuild over a mesh on `device`
        from ..parallel.mesh import make_mesh

        self._covis_mesh = make_mesh(cfg.parallel.covis_devices, device)

    def host_bytes(self) -> Dict[str, int]:
        """Designed host-memory footprint by owner: the fixed numpy pools
        (`pools`), the keyframes' host pyramid mirrors (`kf_pyramids`) and
        their other numpy records (`kf_other`). A long run subtracts it from
        the process RSS to tell the map's bounded growth from the runtime's.
        The device copies (pyr_dev, the LRU) are not host memory and are
        not counted, as in the JAX package."""
        pools = sum(v.nbytes for v in vars(self).values() if isinstance(v, np.ndarray))
        kf_pyr = kf_other = 0
        for kf in self.keyframes:
            for name, v in vars(kf).items():
                if isinstance(v, np.ndarray):
                    if name == "pyr_data":
                        kf_pyr += v.nbytes
                    else:
                        kf_other += v.nbytes
        return {"pools": pools, "kf_pyramids": kf_pyr, "kf_other": kf_other}

    # ---------------- pool saturation ----------------

    def _saturate(self, pool: str) -> int:
        """Graceful pool saturation: count the drop, log the first one per
        pool, return the -1 sentinel."""
        self.saturation_drops[pool] += 1
        if self.saturation_drops[pool] == 1:
            cap = {"keyframes": self.cfg.map.max_keyframes,
                   "points": self.cfg.map.max_points,
                   "texts": self.cfg.map.max_texts}[pool]
            print(f"[map] {pool} pool saturated (cap {cap}) — further "
                  f"{pool} are dropped and counted (SlamMap.saturation_drops)")
        return -1

    # ---------------- keyframes ----------------

    def add_keyframe(self, kf: Keyframe, pose: np.ndarray) -> int:
        kid = len(self.keyframes)
        if kid >= self.cfg.map.max_keyframes:
            return self._saturate("keyframes")
        kf.kid = kid
        self.keyframes.append(kf)
        self.kf_pose[kid] = pose
        self.kf_valid[kid] = True
        # bound device pyramid residency to the BA window (+8 for the theta
        # solvers); older KFs keep only the host mirror
        keep = self.cfg.solver.ba_window + 8
        if kid >= keep:
            old = self.keyframes[kid - keep]
            if old.pyr_dev is not None:
                from ..frontend.frame import host_pyr

                host_pyr(old)  # materialize the host mirror once, then drop
                old.pyr_dev = None
        return kid

    def kf_pyr_dev(self, kf: Keyframe) -> Optional[torch.Tensor]:
        """Device packed pyramid of a keyframe: the resident copy while the
        KF is in the retention window, else an upload of the host mirror
        kept in a small LRU."""
        if kf.pyr_dev is not None:
            return kf.pyr_dev
        if kf.pyr_data is None:
            return None
        dev = self._pyr_lru.pop(kf.kid, None)
        if dev is None:
            dev = torch.as_tensor(kf.pyr_data, dtype=torch.float32, device=self.pyr_device)
        self._pyr_lru[kf.kid] = dev  # (re-)insert as most recent
        while len(self._pyr_lru) > self._pyr_lru_cap:
            self._pyr_lru.pop(next(iter(self._pyr_lru)))
        return dev

    def nearest_kfs(self, frame_id: int, n: int = 2) -> List[int]:
        """Nearest keyframes by frame id."""
        ids = sorted((abs(kf.frame_id - frame_id), kf.kid) for kf in self.keyframes)
        return [k for _, k in ids[:n]]

    def window_kfs(self, window: int) -> List[int]:
        """Last `window` keyframes."""
        n = len(self.keyframes)
        return list(range(max(0, n - window), n))

    # ---------------- scene points ----------------

    def add_point(self, host_kid: int, ray: np.ndarray, rho: float, desc: np.ndarray) -> int:
        pid = self.n_points
        if pid >= self.cfg.map.max_points:
            return self._saturate("points")
        self.pt_host[pid] = host_kid
        self.pt_ray[pid] = ray
        self.pt_rho[pid] = rho
        self.pt_valid[pid] = True
        self.pt_desc[pid] = desc
        self.pt_desc_latest[pid] = desc
        self.pt_desc_second[pid] = desc
        self.n_points += 1
        return pid

    def add_observation(self, kid: int, kp_idx: int, pid: int):
        kf = self.keyframes[kid]
        kf.kp_point[kp_idx] = pid
        kf.obs_good[kp_idx] = True
        obs = self.pt_obs.setdefault(pid, {})
        if kid not in obs:
            self.pt_n_obs[pid] += 1
        obs[kid] = kp_idx
        # roll the viewpoint-adaptive descriptors (nearest = most recent KF)
        self.pt_desc_second[pid] = self.pt_desc_latest[pid]
        self.pt_desc_latest[pid] = kf.kp_desc[kp_idx]

    def tracked_map_points(self, kid: int, min_obs: int) -> int:
        """Count of this KF's good observations whose point is seen by at
        least `min_obs` keyframes (feeds the KF-policy c2 condition)."""
        kf = self.keyframes[kid]
        pids = kf.kp_point[(kf.kp_point >= 0) & kf.obs_good]
        pids = pids[~self.pt_bad[pids]]
        return int((self.pt_n_obs[pids] >= min_obs).sum())

    def cull_bad_points(self, window_kids) -> int:
        """Any observation in the window flagged bad by the BA chi2 gate marks
        its point bad: it leaves the matching pool. Returns the number of
        points newly demoted."""
        n_bad = 0
        for kid in window_kids:
            kf = self.keyframes[kid]
            bad = (kf.kp_point >= 0) & ~kf.obs_good & kf.kp_valid
            pids = np.unique(kf.kp_point[bad])
            pids = pids[(pids >= 0) & ~self.pt_bad[pids]]
            self.pt_bad[pids] = True
            n_bad += len(pids)
        return n_bad

    def point_world(self, pids: np.ndarray) -> np.ndarray:
        """xyz world positions: Twr (ray / rho)."""
        from ..geometry import se3_np

        rho = self.pt_rho[pids].clip(1e-9)
        p_r = self.pt_ray[pids] / rho[:, None]
        return se3_np.apply(se3_np.inverse(self.kf_pose[self.pt_host[pids]]), p_r).astype(np.float32)

    def replace_point(self, old_pid: int, new_pid: int, rebuild: bool = False):
        """Loop fusion: rewire every observation of old into new through the
        per-point registry (O(observations of the point)). Covisibility is
        rebuilt by the caller after the whole fusion batch."""
        obs_old = self.pt_obs.pop(old_pid, {})
        obs_new = self.pt_obs.setdefault(new_pid, {})
        for kid, kp_idx in obs_old.items():
            kf = self.keyframes[kid]
            if kf.kp_point[kp_idx] != old_pid:
                continue  # stale registry entry (keypoint was rebound)
            if kid in obs_new:
                kf.kp_point[kp_idx] = -1  # duplicate obs in this KF: drop
            else:
                kf.kp_point[kp_idx] = new_pid
                obs_new[kid] = kp_idx
                self.pt_n_obs[new_pid] += 1
        self.pt_valid[old_pid] = False
        self.pt_bad[old_pid] = True
        self.pt_n_obs[old_pid] = 0
        if rebuild:
            self.rebuild_covis_m1()

    # ---------------- text objects ----------------

    def add_text(self, host_kid: int, theta, quad, string: str, score: float, lang: int,
                 state=TEXT_IMMATURE) -> int:
        tid = self.n_texts
        if tid >= self.cfg.map.max_texts:
            return self._saturate("texts")
        self.tx_host[tid] = host_kid
        self.tx_theta[tid] = theta
        self.tx_state[tid] = state
        self.tx_valid[tid] = True
        self.tx_quad[tid] = quad
        self.tx_string[tid] = string
        self.tx_score[tid] = score
        self.tx_lang[tid] = lang
        self.n_texts += 1
        return tid

    def add_text_observation(self, kid: int, tid: int, det_idx: int):
        # incremental M2/M3 before registering: +1 shared object and +the
        # level-0 feature count for every KF already observing the object
        if (kid, tid) not in self.tx_obs:
            n_feat = int(self.tx_feat_valid[tid, 0].sum())
            for k2 in self.tx_obs_by_tid.get(tid, ()):
                if k2 != kid:
                    self.M2[kid, k2] += 1
                    self.M2[k2, kid] += 1
                    self.M3[kid, k2] += n_feat
                    self.M3[k2, kid] += n_feat
        self.tx_obs[(kid, tid)] = det_idx
        self.tx_obs_by_kid.setdefault(kid, {})[tid] = det_idx
        self.tx_obs_by_tid.setdefault(tid, {})[kid] = det_idx
        self.tx_inc[tid, kid] = True
        # a fresh observation inherits the object's current feature state
        self.tx_obs_good[(kid, tid)] = True
        self.tx_feat_good[(kid, tid)] = self.tx_feat_valid[tid].copy()
        kf = self.keyframes[kid]
        if kf.det_object is not None and det_idx < len(kf.det_object):
            kf.det_object[det_idx] = tid

    def text_obs_of_kf(self, kid: int) -> List[tuple]:
        return [(t, d) for t, d in self.tx_obs_by_kid.get(kid, {}).items()]

    def kfs_observing_text(self, tid: int) -> List[int]:
        return sorted(self.tx_obs_by_tid.get(tid, {}))

    def rebuild_text_obs_index(self):
        """Recreate the secondary indexes and the incidence from the
        canonical tx_obs dict."""
        self.tx_obs_by_kid = {}
        self.tx_obs_by_tid = {}
        self.tx_inc[:] = False
        for (k, t), d in self.tx_obs.items():
            self.tx_obs_by_kid.setdefault(k, {})[t] = d
            self.tx_obs_by_tid.setdefault(t, {})[k] = d
            self.tx_inc[t, k] = True

    def replace_text(self, old_tid: int, new_tid: int):
        """Loop fusion for text objects: old's observations move to new
        (where new is not observed there yet, inheriting new's feature
        state); old becomes invalid and BAD."""
        for k, d in list(self.tx_obs_by_tid.get(old_tid, {}).items()):
            self.tx_obs.pop((k, old_tid), None)
            self.tx_obs_by_kid.get(k, {}).pop(old_tid, None)
            self.tx_obs_good.pop((k, old_tid), None)
            self.tx_feat_good.pop((k, old_tid), None)
            if (k, new_tid) not in self.tx_obs:
                self.tx_obs[(k, new_tid)] = d
                self.tx_obs_by_kid.setdefault(k, {})[new_tid] = d
                self.tx_obs_by_tid.setdefault(new_tid, {})[k] = d
                self.tx_inc[new_tid, k] = True
                self.tx_obs_good[(k, new_tid)] = True
                self.tx_feat_good[(k, new_tid)] = self.tx_feat_valid[new_tid].copy()
                kf = self.keyframes[k]
                if kf.det_object is not None and d < len(kf.det_object):
                    kf.det_object[d] = new_tid
        self.tx_obs_by_tid.pop(old_tid, None)
        self.tx_inc[old_tid] = False
        self.tx_valid[old_tid] = False
        self.tx_state[old_tid] = TEXT_BAD

    # ---------------- covisibility ----------------

    def _point_incidence(self) -> np.ndarray:
        """[K, n_points] bool observation incidence (good obs only)."""
        inc = np.zeros((len(self.keyframes), max(self.n_points, 1)), bool)
        for kf in self.keyframes:
            pts = kf.kp_point[kf.obs_good & (kf.kp_point >= 0)]
            inc[kf.kid, pts[pts < self.n_points]] = True
        return inc

    def update_covis_on_obs(self, kid: int, pids: np.ndarray):
        """Incremental M1 update when kid gains observations of pids: walk the
        per-point observation registry."""
        counts: Dict[int, int] = {}
        for p in np.atleast_1d(pids):
            if p < 0:
                continue
            for k2 in self.pt_obs.get(int(p), ()):
                if k2 != kid:
                    counts[k2] = counts.get(k2, 0) + 1
        for k2, c in counts.items():
            self.M1[kid, k2] += c
            self.M1[k2, kid] += c

    def _covis_product(self, inc: np.ndarray, w=None) -> np.ndarray:
        """inc @ inc.T (or (inc * w) @ inc.T) with a zero diagonal, int32:
        on the mesh when one is set and the map holds at least covis_min_kfs
        keyframes (the JAX package's crossover on a TPU; chip_smoke.py phase
        9 measures the card's), else on the host: the native threaded
        product, or numpy for the weighted one."""
        if self._covis_mesh is not None and inc.shape[0] >= self.cfg.parallel.covis_min_kfs:
            from ..parallel import covis_sharded

            return covis_sharded.covis_product(inc, self._covis_mesh, w=w)
        if w is None:
            return native.covis_product(inc)
        inc_i = inc.astype(np.int32)
        M = (inc_i * np.asarray(w, np.int32)[None, :]) @ inc_i.T
        np.fill_diagonal(M, 0)
        return M

    def rebuild_covis_m1(self):
        """Full M1 recompute as an incidence-matrix product."""
        K = len(self.keyframes)
        self.M1[:] = 0
        if K == 0:
            return
        inc = self._point_incidence()
        self.M1[:K, :K] = self._covis_product(inc)
        n = min(self.n_points, inc.shape[1])
        self.pt_n_obs[:n] = inc[:, :n].sum(0)

    def rebuild_covis_m23(self):
        """Full M2/M3 recompute as incidence products: M2 = inc inc^T over
        valid text objects, M3 = (inc w) inc^T with w the objects' level-0
        feature counts."""
        K = len(self.keyframes)
        self.M2[:] = 0
        self.M3[:] = 0
        T = self.n_texts
        if K == 0 or T == 0:
            return
        inc = np.zeros((K, T), bool)
        for (k, t) in self.tx_obs:
            if t < T and self.tx_valid[t]:
                inc[k, t] = True
        w = self.tx_feat_valid[:T, 0].sum(axis=1)
        self.M2[:K, :K] = self._covis_product(inc)
        self.M3[:K, :K] = self._covis_product(inc, w=w)

    def covisible_kfs_sorted(self, kid: int):
        """(kids, weights) of the KFs with M1[kid] > 0, by weight descending
        (ties in id order)."""
        K = len(self.keyframes)
        w = self.M1[kid, :K].copy()
        w[kid] = 0
        nz = np.nonzero(w > 0)[0]
        order = nz[np.argsort(-w[nz], kind="stable")]
        return order, w[order]

    def covisible_prev(self, kid: int) -> np.ndarray:
        """Previous KFs (id < kid) with M1 covisibility > 0."""
        return np.nonzero(self.M1[kid, :kid] > 0)[0]


_MAP_ARRAYS = ("kf_pose", "kf_valid", "pt_host", "pt_ray", "pt_rho", "pt_valid", "pt_bad",
               "pt_desc", "pt_desc_latest", "pt_desc_second", "pt_good_obs", "pt_bad_obs",
               "pt_n_obs", "M1", "M2", "M3", "tx_host", "tx_theta", "tx_state", "tx_valid",
               "tx_quad", "tx_score", "tx_sem_score", "tx_lang", "tx_good_obs", "tx_bad_obs",
               "tx_num_obvs", "tx_cov", "tx_feat_uv", "tx_feat_ref", "tx_feat_valid", "tx_inc")
_KF_FIELDS = ("kid", "frame_id", "timestamp", "kp_uv", "kp_level", "kp_angle", "kp_desc",
              "kp_valid", "kp_point", "obs_good", "pyr_data", "pyr_shapes", "det_quads",
              "det_text", "det_object", "loop_edges")


def slam_map_from_numpy(fields: Mapping, cfg: TextSLAMConfig, *, device) -> SlamMap:
    """Build a port SlamMap from a JAX SlamMap's state (`vars(jax_map)`):
    the scene and text pools, M1/M2/M3, the observation registries and the
    keyframe records (each a Keyframe or its vars()). Arrays are copied with
    the port's dtypes; a keyframe's device pyramid (`pyr_dev`, any array)
    becomes a float32 tensor on `device`; detections keep their records
    (anything with quad / text / score / lang)."""
    from ..frontend.frame import TextDetection, check_device

    dev = check_device(device, "slam_map_from_numpy")
    m = SlamMap(cfg, device=dev)
    for name in _MAP_ARRAYS:
        dst = getattr(m, name)
        src = np.asarray(fields[name])
        if src.shape != dst.shape:
            raise ValueError(f"{name}: shape {src.shape} does not match the config's {dst.shape}")
        dst[...] = src
    m.n_points = int(fields["n_points"])
    m.n_texts = int(fields["n_texts"])
    m.tx_string = list(fields["tx_string"])
    m.pt_obs = {int(p): {int(k): int(i) for k, i in obs.items()}
                for p, obs in fields["pt_obs"].items()}
    m.tx_obs = {(int(k), int(t)): int(d) for (k, t), d in fields["tx_obs"].items()}
    for name in ("tx_obs_by_kid", "tx_obs_by_tid"):
        setattr(m, name, {int(a): {int(b): int(d) for b, d in inner.items()}
                          for a, inner in fields[name].items()})
    m.tx_obs_good = {(int(k), int(t)): bool(v) for (k, t), v in fields["tx_obs_good"].items()}
    m.tx_feat_good = {(int(k), int(t)): np.array(v, bool)
                      for (k, t), v in fields["tx_feat_good"].items()}
    m.saturation_drops.update(fields.get("saturation_drops", {}))
    for kf in fields["keyframes"]:
        d = kf if isinstance(kf, Mapping) else vars(kf)
        rec = {k: (np.array(d[k]) if isinstance(d[k], np.ndarray) else d.get(k))
               for k in _KF_FIELDS}
        rec["loop_edges"] = [int(e) for e in rec["loop_edges"] or ()]
        if rec["det_text"] is not None:
            rec["det_text"] = [TextDetection(quad=np.asarray(t.quad, np.float32), text=t.text,
                                             score=float(t.score), lang=int(t.lang))
                               for t in rec["det_text"]]
        if d.get("pyr_dev") is not None:
            rec["pyr_dev"] = torch.tensor(np.asarray(d["pyr_dev"]), dtype=torch.float32,
                                          device=dev)
        m.keyframes.append(Keyframe(**rec))
    return m
