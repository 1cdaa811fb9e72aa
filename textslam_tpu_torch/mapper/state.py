"""SoA map state: keyframes, scene points, observations, covisibility.

Port of textslam_tpu/mapper/state.py for the scene-only slice. The map is
host-side numpy bookkeeping, as in the JAX package: id allocation,
observation registries and the covisibility matrix M1 are O(landmarks)
integer work per keyframe, and every device consumer (matching, BA) gathers
padded tensors from these pools. Descriptors stay uint32 on the host (the
JAX package's layout); they become int32 bits on the way to the device.

Not in this slice: text-object pools and the M2/M3 text covisibility (text
slice), loop edges, point fusion and world-point queries (loop closing), the
native covisibility product and its sharded variant (the numpy product is
used).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping

import numpy as np

from ..config import TextSLAMConfig


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


class SlamMap:
    """Pool-backed map. Ids are stable array indices."""

    def __init__(self, cfg: TextSLAMConfig):
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

        self.saturation_drops: Dict[str, int] = {"keyframes": 0, "points": 0}

        # scene covisibility (#shared points between keyframes)
        self.M1 = np.zeros((m.max_keyframes, m.max_keyframes), np.int32)

    # ---------------- pool saturation ----------------

    def _saturate(self, pool: str) -> int:
        """Graceful pool saturation: count the drop, log the first one per
        pool, return the -1 sentinel."""
        self.saturation_drops[pool] += 1
        if self.saturation_drops[pool] == 1:
            cap = {"keyframes": self.cfg.map.max_keyframes,
                   "points": self.cfg.map.max_points}[pool]
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
        return kid

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

    def rebuild_covis_m1(self):
        """Full M1 recompute as an incidence-matrix product (numpy)."""
        K = len(self.keyframes)
        self.M1[:] = 0
        if K == 0:
            return
        inc = self._point_incidence().astype(np.int32)
        M = inc @ inc.T
        np.fill_diagonal(M, 0)
        self.M1[:K, :K] = M
        n = min(self.n_points, inc.shape[1])
        self.pt_n_obs[:n] = inc[:, :n].sum(0)


_MAP_ARRAYS = ("kf_pose", "kf_valid", "pt_host", "pt_ray", "pt_rho", "pt_valid", "pt_bad",
               "pt_desc", "pt_desc_latest", "pt_desc_second", "pt_good_obs", "pt_bad_obs",
               "pt_n_obs", "M1")
_KF_FIELDS = ("kid", "frame_id", "timestamp", "kp_uv", "kp_level", "kp_angle", "kp_desc",
              "kp_valid", "kp_point", "obs_good")


def slam_map_from_numpy(fields: Mapping, cfg: TextSLAMConfig) -> SlamMap:
    """Build a port SlamMap from a JAX SlamMap's state (`vars(jax_map)`,
    arrays as numpy): the scene pools, M1, the observation registry and the
    keyframe records (each a Keyframe or its vars()). Text fields are
    ignored. Arrays are copied with the port's dtypes."""
    m = SlamMap(cfg)
    for name in _MAP_ARRAYS:
        dst = getattr(m, name)
        src = np.asarray(fields[name])
        if src.shape != dst.shape:
            raise ValueError(f"{name}: shape {src.shape} does not match the config's {dst.shape}")
        dst[...] = src
    m.n_points = int(fields["n_points"])
    m.pt_obs = {int(p): {int(k): int(i) for k, i in obs.items()}
                for p, obs in fields["pt_obs"].items()}
    for kf in fields["keyframes"]:
        d = kf if isinstance(kf, Mapping) else vars(kf)
        m.keyframes.append(Keyframe(
            **{k: (np.array(d[k]) if isinstance(d[k], np.ndarray) else d[k]) for k in _KF_FIELDS}))
    return m
