"""The long-sequence regime of the port held against the JAX package, on
the host, without rendering: pool caps derived from the sequence length
(MapConfig.derive), the map's bookkeeping at 120 keyframes with loop-time
fusion and covisibility rebuilds (tests/test_bookkeeping_scale.py's
drive_sequence, with its bound on per-KF cost growth), pool saturation,
host_bytes, the tracker's local-map narrowing and the point pool's cap in
_triangulate_new.

Tolerance: exact for every integer and boolean output (covisibility,
indexes, masks, counters, byte counts); the triangulated points to 1e-5
relative (the same float32 triangulation in two frameworks).
"""

import dataclasses
import time
import types

import numpy as np
import pytest
import torch

from textslam_tpu import config as jcfg
from textslam_tpu.frontend import tracking as jtracking
from textslam_tpu.mapper import state as jstate
from textslam_tpu_torch import config as tcfg
from textslam_tpu_torch.frontend import tracking as ttracking
from textslam_tpu_torch.mapper import state as tstate

torch.set_num_threads(2)

PKGS = {"jax": (jcfg, jstate), "torch": (tcfg, tstate)}


@pytest.mark.parametrize("fps", [1.0, 3.0, 6.0, 10.0, 30.0, 60.0])
def test_map_config_derive_matches(fps):
    for n in (1, 10, 120, 200, 1000, 5000, 100_000):
        for base in (None, dict(max_obs_per_kf=1024, local_map_kf_cap=40)):
            jb = None if base is None else jcfg.MapConfig(**base)
            tb = None if base is None else tcfg.MapConfig(**base)
            assert (dataclasses.asdict(tcfg.MapConfig.derive(n, fps, tb))
                    == dataclasses.asdict(jcfg.MapConfig.derive(n, fps, jb))), (n, fps, base)


def _cfg(pkg, **map_kw):
    cfg_mod, _ = PKGS[pkg]
    return cfg_mod.TextSLAMConfig(
        no_text=True,
        camera=cfg_mod.CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=120.0, width=320,
                                    height=240, fps=10.0),
        map=cfg_mod.MapConfig(**map_kw))


def _map(pkg, **map_kw):
    _, st = PKGS[pkg]
    cfg = _cfg(pkg, **map_kw)
    return st.SlamMap(cfg) if pkg == "jax" else st.SlamMap(cfg, device="cpu")


def _kf(pkg, kid, frame_id, n=256, pyr=None):
    _, st = PKGS[pkg]
    return st.Keyframe(
        kid=kid, frame_id=frame_id, timestamp=float(frame_id),
        kp_uv=np.zeros((n, 2), np.float32), kp_level=np.zeros(n, np.int32),
        kp_angle=np.zeros(n, np.float32), kp_desc=np.zeros((n, 8), np.uint32),
        kp_valid=np.ones(n, bool), kp_point=np.full(n, -1, np.int32),
        obs_good=np.zeros(n, bool), pyr_data=pyr,
        det_object=np.full(8, -1, np.int32))


def drive_sequence(pkg, m, n_kfs, pts_per_kf=64, overlap=32, texts_per_kf=2, fuse_every=0,
                   pyr_every=0):
    """tests/test_bookkeeping_scale.py's drive_sequence on either package's
    map: new points, re-observations of the previous KF's points, text
    observations re-observed by the next 3 KFs; plus, every `fuse_every`
    KFs, a loop-time fusion (replace_point(rebuild=True) of an old point
    into a new one, then the M2/M3 rebuild), a loop edge and a small host
    pyramid on every `pyr_every`-th KF. Pool saturation is skipped as
    _triangulate_new skips it. Returns the per-KF seconds."""
    _, st = PKGS[pkg]
    rng = np.random.default_rng(0)
    per_kf, prev_pids = [], []
    T0 = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
    for kid in range(n_kfs):
        t0 = time.perf_counter()
        pyr = (rng.random((2, 12, 16, 3), np.float32) if pyr_every and kid % pyr_every == 0
               else None)
        if m.add_keyframe(_kf(pkg, kid, kid * 5, pyr=pyr), T0) < 0:
            per_kf.append(time.perf_counter() - t0)
            continue
        kp, new_pids = 0, []
        for _ in range(pts_per_kf):
            pid = m.add_point(kid, np.array([0, 0, 1.0], np.float32), 1.0,
                              np.zeros(8, np.uint32))
            if pid < 0:
                continue
            m.add_observation(kid, kp, pid)
            new_pids.append(pid)
            kp += 1
        for pid in prev_pids[:overlap]:
            m.add_observation(kid, kp, pid)
            kp += 1
        m.update_covis_on_obs(kid, np.asarray(new_pids + prev_pids[:overlap]))
        for i in range(texts_per_kf):
            tid = m.add_text(kid, np.array([0, 0, -1.0], np.float32), np.zeros((4, 2), np.float32),
                             f"text{kid}_{i}", 0.9, 0, state=st.TEXT_GOOD)
            if tid < 0:
                continue
            m.tx_feat_valid[tid, 0, :16] = True
            m.add_text_observation(kid, tid, i)
        for back in range(1, 4):
            k2 = kid - back
            if k2 < 0:
                continue
            for (t, _) in list(m.text_obs_of_kf(k2))[:texts_per_kf]:
                if (kid, t) not in m.tx_obs:
                    m.add_text_observation(kid, t, texts_per_kf + back)
        if fuse_every and kid and kid % fuse_every == 0 and new_pids:
            old = int(rng.integers(0, new_pids[0]))
            if m.pt_valid[old]:
                m.replace_point(old, new_pids[-1], rebuild=True)
                m.keyframes[kid].loop_edges.append(int(m.pt_host[old]))
            m.rebuild_covis_m23()
        prev_pids = new_pids
        per_kf.append(time.perf_counter() - t0)
    return np.asarray(per_kf)


def _assert_maps_equal(mj, mt):
    K = len(mj.keyframes)
    assert len(mt.keyframes) == K
    assert (mt.n_points, mt.n_texts) == (mj.n_points, mj.n_texts)
    for name in ("M1", "M2", "M3", "pt_valid", "pt_bad", "pt_n_obs", "pt_host", "tx_inc"):
        np.testing.assert_array_equal(getattr(mt, name), getattr(mj, name), err_msg=name)
    for kid in range(K):
        np.testing.assert_array_equal(mt.covisible_prev(kid), mj.covisible_prev(kid))
        for a, b in zip(mt.covisible_kfs_sorted(kid), mj.covisible_kfs_sorted(kid)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(mt.keyframes[kid].kp_point, mj.keyframes[kid].kp_point)
        assert mt.keyframes[kid].loop_edges == mj.keyframes[kid].loop_edges
    assert mt.tx_obs == mj.tx_obs
    assert mt.tx_obs_by_kid == mj.tx_obs_by_kid and mt.tx_obs_by_tid == mj.tx_obs_by_tid
    assert mt.pt_obs == mj.pt_obs
    assert mt.saturation_drops == mj.saturation_drops


@pytest.fixture(scope="module")
def driven():
    """Both packages' maps after 120 KFs with a fusion every 10 KFs: the
    default pools, and pools small enough that points, texts and keyframes
    saturate. Also the port's per-KF times."""
    out = {}
    for pools in ("default", "small"):
        kw = {} if pools == "default" else dict(max_keyframes=100, max_points=4096,
                                                max_texts=150)
        maps = {pkg: _map(pkg, **kw) for pkg in PKGS}
        times = {pkg: drive_sequence(pkg, maps[pkg], 120, fuse_every=10, pyr_every=7)
                 for pkg in PKGS}
        out[pools] = (maps, times)
    return out


@pytest.mark.parametrize("pools", ["default", "small"])
def test_bookkeeping_matches_at_120_kfs(driven, pools):
    maps, _ = driven[pools]
    _assert_maps_equal(maps["jax"], maps["torch"])
    m = maps["torch"]
    if pools == "default":
        assert m.saturation_drops == {"keyframes": 0, "points": 0, "texts": 0}
    else:
        assert all(v > 0 for v in m.saturation_drops.values()), m.saturation_drops
        assert m.n_points == 4096 and m.n_texts == 150 and len(m.keyframes) == 100
    # the incremental M1/M2/M3 against a full recompute (the fusions left
    # every matrix rebuilt; rebuild again from scratch)
    for name, rebuild in (("M1", m.rebuild_covis_m1), ("M2", m.rebuild_covis_m23)):
        before = getattr(m, name).copy()
        rebuild()
        np.testing.assert_array_equal(getattr(m, name), before)


def test_per_kf_cost_stays_flat(driven):
    """test_bookkeeping_scale's bound: per-KF bookkeeping at KF 100-120
    within 8x of KF 20-40, and under 50 ms (the port's map, fusion and
    rebuilds through the native product included on every tenth KF, so the
    median is taken as there)."""
    _, times = driven["default"]
    t = times["torch"]
    early, late = np.median(t[20:40]), np.median(t[100:120])
    assert late < 8 * max(early, 1e-5), f"per-KF bookkeeping grew {late / early:.1f}x"
    assert late < 0.05


@pytest.mark.parametrize("pools", ["default", "small"])
def test_host_bytes(driven, pools):
    """kf_pyramids and kf_other exactly JAX's; pools too (the port's map
    holds the same numpy pools; the device LRU and the pyramid device copies
    are not host numpy in either package)."""
    maps, _ = driven[pools]
    hj, ht = maps["jax"].host_bytes(), maps["torch"].host_bytes()
    assert ht == hj
    n_pyr = len([kf for kf in maps["torch"].keyframes if kf.pyr_data is not None])
    assert ht["kf_pyramids"] == n_pyr * 2 * 12 * 16 * 3 * 4 > 0


def _trackers(maps):
    return {"jax": jtracking.Tracker(maps["jax"].cfg, maps["jax"]),
            "torch": ttracking.Tracker(maps["torch"].cfg, maps["torch"], device="cpu")}


@pytest.mark.parametrize("frame_id,cap", [(597, 8), (300, 8), (597, 80)])
def test_narrowing_matches(frame_id, cap):
    """On one map past max_points // 2, the candidate mask of
    _candidate_valid (through _narrow_to_local_map) is JAX's, and it does
    narrow: only points hosted by the nearest KF's local_map_kf_cap most
    covisible KFs and its loop edges stay."""
    maps = {pkg: _map(pkg, max_points=8192, local_map_kf_cap=cap) for pkg in PKGS}
    for pkg, m in maps.items():
        drive_sequence(pkg, m, 120, fuse_every=10)
    m = maps["torch"]
    assert m.n_points > m.cfg.map.max_points // 2
    tr = _trackers(maps)
    frame = types.SimpleNamespace(frame_id=frame_id)
    P = 8192
    got = tr["torch"]._candidate_valid(frame, P)
    want = tr["jax"]._candidate_valid(frame, P)
    np.testing.assert_array_equal(got, want)
    live = m.pt_valid[: m.n_points] & ~m.pt_bad[: m.n_points]
    assert 50 < got.sum() < live.sum()
    near = m.nearest_kfs(frame_id, 1)[0]
    hosts = set(np.unique(m.pt_host[: m.n_points][got[: m.n_points]]).tolist())
    assert near in hosts and len(hosts) <= cap + 1 + len(m.keyframes[near].loop_edges)
    # below half the pool nothing narrows
    small = {pkg: _map(pkg, max_points=32768, local_map_kf_cap=cap) for pkg in PKGS}
    for pkg, mm in small.items():
        drive_sequence(pkg, mm, 30)
    mm = small["torch"]
    full = _trackers(small)["torch"]._candidate_valid(frame, P)
    np.testing.assert_array_equal(full[: mm.n_points],
                                  mm.pt_valid[: mm.n_points] & ~mm.pt_bad[: mm.n_points])


def _pair_keyframes(pkg, n=400, seed=0):
    """Two keyframes 0.3 m apart observing n points of a 3-5 m deep cloud,
    each point's keypoint with one random descriptor in both (the map
    driven directly: no rendering)."""
    rng = np.random.default_rng(seed)
    fx = fy = 400.0
    cx, cy = 160.0, 120.0
    X = np.stack([rng.uniform(-2.5, 2.5, n), rng.uniform(-1.8, 1.8, n),
                  rng.uniform(3.0, 5.0, n)], -1)
    desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    poses = [np.array([1, 0, 0, 0, 0, 0, 0], np.float32),
             np.array([1, 0, 0, 0, -0.3, 0, 0], np.float32)]
    kfs = []
    for k, T in enumerate(poses):
        pc = X + T[4:]
        uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], -1)
        kf = _kf(pkg, -1, k * 5, n=n)
        kf.kp_uv = uv.astype(np.float32)
        kf.kp_desc = desc.copy()
        kfs.append(kf)
    return kfs, poses


@pytest.mark.parametrize("room", [0, 37, 1000])
def test_triangulation_stops_at_point_cap(room):
    """_triangulate_new between two keyframes fills the point pool up to
    its cap and counts the rest as saturation drops, as JAX's does; the
    points it makes are JAX's."""
    cap = 1024
    maps = {pkg: _map(pkg, max_points=cap) for pkg in PKGS}
    for pkg, m in maps.items():
        for _ in range(cap - room):
            m.add_point(0, np.array([0, 0, 1.0], np.float32), 1.0, np.zeros(8, np.uint32))
        kfs, poses = _pair_keyframes(pkg)
        for kf, T in zip(kfs, poses):
            m.add_keyframe(kf, T)
    tr = _trackers(maps)
    for pkg in PKGS:
        tr[pkg]._triangulate_new(1)
    mj, mt = maps["jax"], maps["torch"]
    made = mt.n_points - (cap - room)
    assert mt.n_points <= cap
    assert made == min(room, made + mt.saturation_drops["points"])
    assert made + mt.saturation_drops["points"] > 300  # most of the 400 pairs triangulate
    if room < 400:
        assert mt.n_points == cap and mt.saturation_drops["points"] > 0
    assert (mt.n_points, mt.saturation_drops) == (mj.n_points, mj.saturation_drops)
    n = mt.n_points
    np.testing.assert_array_equal(mt.pt_host[:n], mj.pt_host[:n])
    np.testing.assert_allclose(mt.pt_ray[:n], mj.pt_ray[:n], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mt.pt_rho[:n], mj.pt_rho[:n], rtol=1e-5)
    for k in range(2):
        np.testing.assert_array_equal(mt.keyframes[k].kp_point, mj.keyframes[k].kp_point)
    np.testing.assert_array_equal(mt.M1, mj.M1)
