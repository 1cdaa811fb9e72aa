"""Port loop closing (textslam_tpu_torch.loop.closing and the map, tracker
and text-frontend operations it uses) held against the JAX package.

The loop-logic tests run on maps built directly (no SLAM run): identical
operations go into a JAX SlamMap and a port SlamMap.
- tests/test_loop_logic.py's cases (its make_map): _thresh_words and detect
  exact, including the long-string host path, and the SearchAndFuse_Text
  cases' fusions exact.
- An out-and-back map of the rendered text world (tests/torch_synth.py,
  320x240, 10 keyframes along the `outback` path): the first leg in the true
  frame, the return leg a duplicate map (its own points, text objects and
  observations of the same world) in a frame drifted by a Sim3, with the
  keyframes' packed pyramids and the objects' reference features. On it:
  replace_point / replace_text and the rebuilt M1/M2/M3 exact; detect,
  compute_sim3 (the Sim3 RANSAC on the JAX package's own 3-point sets,
  injected) and correct: the same candidate, inlier counts and fusion
  pairs, the pose graph's input exact to float32 and its poses to 1e-4;
  the scene-only global BA and the landmark-only BA by their final cost, to
  1e-3 relative (ROADMAP C, "LM path sensitivity": the LM paths may part
  after a near-tie accept decision, so a whole solve compares by cost);
  landmark_theta_pass (the decomposed landmark pass) thetas to 1e-3
  relative.
- The import check: the port's system and loop modules load no jax.

The slice as a whole (the port alone on the rendered outback fixture, from
scratch) is tests/test_torch_loop_e2e.py.
"""

import copy
import gzip
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_loop_logic as tll
import torch_synth
from textslam_tpu import config as jcfg
from textslam_tpu.frontend import text as jtext
from textslam_tpu.frontend.text import TextFrontend as JTextFrontend
from textslam_tpu.frontend.tracking import Tracker as JTracker
from textslam_tpu.loop import closing as jclosing
from textslam_tpu.mapper import state as jstate
from textslam_tpu_torch import config as tcfg
from textslam_tpu_torch.frontend import text as ttext
from textslam_tpu_torch.frontend.text import TextFrontend as TTextFrontend
from textslam_tpu_torch.frontend.tracking import Tracker as TTracker
from textslam_tpu_torch.geometry import se3_np
from textslam_tpu_torch.loop import closing as tclosing
from textslam_tpu_torch.mapper import state as tstate
from textslam_tpu_torch.ops import pyramid
from textslam_tpu_torch.solver import ba as tba

torch.set_num_threads(2)

# keyframes at every third frame of a 32-frame outback path, the middle
# skipped: no return-leg keyframe stands where a first-leg one stood (with
# zero baseline between the two the Sim3's scale is unobservable by
# reprojection and the refinement drifts along it)
FRAMES = [0, 3, 6, 9, 12, 18, 21, 24, 27, 30]
N_KF = len(FRAMES)
SIZE = (320, 240)


# ---------------------------------------------------------------------------
# test_loop_logic's maps in both packages


def _port_cfg_like(jc):
    """The port config with a JAX config's values (same dataclass layout)."""
    def conv(obj, mod):
        if hasattr(obj, "__dataclass_fields__"):
            cls = getattr(mod, type(obj).__name__)
            return cls(**{f: conv(getattr(obj, f), mod) for f in obj.__dataclass_fields__})
        if type(obj).__name__ == "Experiment":
            return mod.Experiment(obj.value)
        return obj
    return conv(jc, tcfg)


def _port_map_like(jm, cfg):
    """A port SlamMap with a JAX SlamMap's state."""
    return tstate.slam_map_from_numpy(vars(jm), cfg, device="cpu")


def _pair(experiment=jcfg.Experiment.INDOOR_LOOP_A, n_kfs=14, **loop):
    jc = tll.make_cfg(experiment, **loop)
    jm = tll.make_map(jc, n_kfs)
    return jc, jm, _port_cfg_like(jc)


def _detect_both(jc, jm, tc, kid, min_words):
    tm = _port_map_like(jm, tc)
    j = jclosing.LoopCloser(jc, jm)
    t = tclosing.LoopCloser(tc, tm, device="cpu")
    out = (j.detect(kid, min_words, frozenset()), t.detect(kid, min_words, frozenset()))
    assert out[1] == out[0]
    return out[0]


def _add_text(m, host, s, obs):
    tid = m.add_text(host, np.zeros(3, np.float32), np.zeros((4, 2), np.float32), s, 0.9, 0,
                     state=jstate.TEXT_GOOD)
    for k, d in obs:
        m.add_text_observation(k, tid, d)
    return tid


@pytest.mark.parametrize("case", ["votes", "exact", "covisible", "hash", "long_device",
                                  "long_host", "truncation", "random_pool"])
def test_detect_matches_jax(case):
    """test_loop_logic's detect cases (and a random 300-text pool) give the
    same candidates in both packages."""
    long_a = tll.TestLongStrings.LONG_A
    lc = {"long_host": {"lev_device_max_len": 16}}.get(case, {})
    jc, jm, tc = _pair(**lc)
    kid, min_words = 13, 0
    if case == "votes":
        for i, s in enumerate(["EXIT", "HOTEL"]):
            _add_text(jm, 2, s, [(2, i)] + ([(3, 0)] if i == 0 else []))
        for i, s in enumerate(["EXIT", "HOTEL"]):
            _add_text(jm, kid, s, [(kid, i)])
        min_words = 1
    elif case in ("exact", "covisible", "hash"):
        s = {"exact": "ABCDEF", "covisible": "EXIT", "hash": "AB#CD"}[case]
        _add_text(jm, 2, s, [(2, 0)])
        if case == "exact":
            _add_text(jm, 3, "ABCDEX", [(3, 0)])
        _add_text(jm, kid, s, [(kid, 0)])
        if case == "covisible":
            jm.M1[kid, 2] = jm.M1[2, kid] = 7
    elif case in ("long_device", "long_host", "truncation"):
        a, b = {"long_device": (long_a, tll.TestLongStrings.LONG_B),
                "long_host": (long_a, tll.TestLongStrings.LONG_C),
                "truncation": ("SAME-PREFIX-0123-BUT-THEN-COMPLETELY-DIFFERENT",
                               "SAME-PREFIX-0123-XXXXXXXXXXXXXXXXXXXXXXXXXXXXX")}[case]
        _add_text(jm, 2, b, [(2, 0), (3, 0)])
        _add_text(jm, kid, a, [(kid, 0)])
    else:
        rng = np.random.default_rng(5)
        alpha = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"))
        cur = ["".join(rng.choice(alpha, int(rng.integers(5, 19)))) for _ in range(6)]
        for i in range(300):
            host = int(rng.integers(0, kid - 2))
            s = (cur[i % 6] if i < 18 else cur[i % 6][:-1] + "X" if i < 30
                 else "".join(rng.choice(alpha, int(rng.integers(5, 19)))))
            _add_text(jm, host, s, [(host, 0)] + ([(host + 1, 1)] if i % 3 == 0 else []))
        for i, s in enumerate(cur):
            _add_text(jm, kid, s, [(kid, i)])
        min_words = 1
    out = _detect_both(jc, jm, tc, kid, min_words)
    expect_nonempty = case in ("votes", "exact", "long_device", "long_host", "random_pool")
    assert bool(out) == expect_nonempty, out


@pytest.mark.parametrize("n_covis", [5, 11])
def test_thresh_words_matches_jax(n_covis):
    jc, jm, tc = _pair(n_kfs=20, num_covis_for_thresh=3)
    kid = 19
    rng = np.random.default_rng(n_covis)
    for k in range(19 - n_covis, 19):
        jm.M1[kid, k] = jm.M1[k, kid] = int(rng.integers(1, 50))
        jm.M2[kid, k] = jm.M2[k, kid] = int(rng.integers(0, 6))
    jm.M1[17, 2] = jm.M1[2, 17] = 3  # a 2-hop neighbour
    tm = _port_map_like(jm, tc)
    j = jclosing.LoopCloser(jc, jm)._thresh_words(kid)
    t = tclosing.LoopCloser(tc, tm, device="cpu")._thresh_words(kid)
    assert t == j


@pytest.mark.parametrize("case", ["overlap", "disjoint", "behind"])
def test_search_and_fuse_text_matches_jax(case):
    jc, jm, tc = _pair(n_kfs=6)
    quad = np.array([[100, 100], [200, 100], [200, 160], [100, 160]], np.float32)
    theta = np.array([0, 0, -0.5], np.float32)
    tA = jm.add_text(1, theta, quad, "EXIT", 0.9, 0, state=jstate.TEXT_GOOD)
    jm.add_text_observation(1, tA, 0)
    q2 = quad + np.array([150, 60], np.float32) if case == "disjoint" else quad.copy()
    tB = jm.add_text(4, theta, q2, "EXIT", 0.8, 0, state=jstate.TEXT_GOOD)
    jm.add_text_observation(4, tB, 0)
    pose = np.array([1, 0, 0, 0, 0, 0, 10.0 if case == "behind" else 0.0], np.float32)
    tm = _port_map_like(jm, tc)
    j = jclosing.LoopCloser(jc, jm)
    j.tracker = types.SimpleNamespace(text_frontend=JTextFrontend(jc, jm, None))
    t = tclosing.LoopCloser(tc, tm, device="cpu")
    t.tracker = types.SimpleNamespace(text_frontend=TTextFrontend(tc, tm, None, device="cpu"))
    n = (j._search_and_fuse_text(5, 1, {4}, {4: pose}, [tA]),
         t._search_and_fuse_text(5, 1, {4}, {4: pose}, [tA]))
    assert n[1] == n[0] == (1 if case == "overlap" else 0)
    assert set(tm.tx_obs) == set(jm.tx_obs)
    np.testing.assert_array_equal(tm.tx_valid, jm.tx_valid)


# ---------------------------------------------------------------------------
# the out-and-back duplicated map


def _cfg(mod, **solver):
    return mod.TextSLAMConfig(
        camera=mod.CameraConfig(fx=210.0, fy=210.0, cx=160.0, cy=120.0, width=SIZE[0],
                                height=SIZE[1], fps=6.0),
        loop=mod.LoopConfig(min_kfs_before_loop=6, min_kfs_between_loops=5,
                            num_covis_for_thresh=3),
        # the landmark schedule cut to 2 levels x 5 iterations for the CPU
        pyramid=mod.PyramidConfig(landmark_levels=(1, 0)),
        solver=mod.SolverConfig(iters_landmark=5, **solver),
    )


def _spec():
    """Everything both maps are built from (numpy; deterministic)."""
    rng = np.random.default_rng(3)
    K = torch_synth.K.copy()
    K[:2] /= 2
    # text boxes twice the renderer's default size: at 320x240 a default box
    # on the far planes spans ~13x6 px, its plane is barely observable, and
    # the photometric LM wanders along the flat directions, where the two
    # packages' float32 rounding decides its path
    world = torch_synth.TextWorld(seed=0, box_px=((280, 440), (140, 220)))
    gt = torch_synth.camera_path(32, "outback")[FRAMES]
    # the return leg's map lives in a frame drifted by the Sim3 (qD, tD, sD)
    qD = torch_synth._qexp(np.array([0.0, 0.03, -0.02]))
    tD = np.array([0.04, -0.02, 0.03], np.float32)
    sD = 1.06
    TD_inv = se3_np.inverse(np.concatenate([qD, tD]).astype(np.float32))
    est = gt.copy()
    for k in range(N_KF // 2, N_KF):
        est[k] = se3_np.compose(np.concatenate([gt[k][:4], sD * gt[k][4:]]).astype(np.float32),
                                TD_inv)
    # world points on the planes' textured areas, one descriptor each
    pts = []
    for z0, s, tex, mask, off in world.planes:
        ys, xs = np.nonzero(mask)
        sel = rng.choice(len(ys), 90, replace=False)
        th, tw = tex.shape
        pts.append(np.stack([(xs[sel] - tw / 2) / s + off[0], (ys[sel] - th / 2) / s + off[1],
                             np.full(90, z0)], -1))
    X = np.concatenate(pts).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (len(X), 8), dtype=np.uint64).astype(np.uint32)
    kfs = []
    for k in range(N_KF):
        pc = se3_np.apply(gt[k], X)
        uv = np.stack([K[0, 0] * pc[:, 0] / pc[:, 2] + K[0, 2],
                       K[1, 1] * pc[:, 1] / pc[:, 2] + K[1, 2]], -1)
        vis = np.nonzero((pc[:, 2] > 0.1) & (uv[:, 0] > 4) & (uv[:, 0] < SIZE[0] - 4)
                         & (uv[:, 1] > 4) & (uv[:, 1] < SIZE[1] - 4))[0]
        d = desc[vis].copy()
        flips = rng.integers(0, 256, (len(vis), 2))
        for j in range(2):  # two flipped bits per observation
            d[np.arange(len(vis)), flips[:, j] // 32] ^= (np.uint32(1) << (flips[:, j] % 32)
                                                         ).astype(np.uint32)
        img = world.render(gt[k], K_mat=K, size=SIZE)
        imgs, grads = pyramid.build_pyramid(torch.tensor(img, dtype=torch.float32), levels=4)
        packed = pyramid.pack_pyramid(imgs, grads)
        kfs.append(dict(wid=vis, uv=(uv[vis] + rng.normal(0, 0.2, (len(vis), 2))).astype(np.float32),
                        desc=d, bind=rng.uniform(size=len(vis)) < 0.85,
                        dets=world.detections(gt[k], K_mat=K, size=SIZE),
                        pyr=packed["data"].numpy(), shapes=np.asarray(packed["shapes"])))
    return dict(world=world, gt=gt, est=est, X=X, sD=sD, qD=qD, tD=tD, kfs=kfs, desc=desc)


def _features(cfg, pyr, shapes, quad):
    """An object's per-level reference features from its host pyramid (the
    port's extraction; both maps receive the same arrays)."""
    L, F = len(cfg.pyramid.theta_levels) + 1, cfg.text.max_features_per_level
    B = min(cfg.text.max_box_pixels, 1024)
    packed = ttext._extract_reference(torch.tensor(pyr), shapes, torch.tensor(quad), n_levels=L,
                                      n_feat=F, n_box=B).numpy()
    uv = packed[: L * F * 2].reshape(L, F, 2)
    ref = packed[L * F * 2: L * F * 10].reshape(L, F, 8)
    valid = packed[L * F * 10: L * F * 11].reshape(L, F) > 0.5
    return uv, ref, valid


def _build(spec, cfg, state_mod, pyr_of, new_map):
    """The duplicated map: legs [0, N/2) and [N/2, N), each with its own
    points (hosted at the leg's first observing KF) and text objects."""
    m = new_map(cfg)
    kfs = spec["kfs"]
    for k, kd in enumerate(kfs):
        n = len(kd["wid"])
        dets = kd["dets"]
        m.add_keyframe(state_mod.Keyframe(
            kid=k, frame_id=k, timestamp=float(k), kp_uv=kd["uv"], kp_level=np.zeros(n, np.int32),
            kp_angle=np.zeros(n, np.float32), kp_desc=kd["desc"], kp_valid=np.ones(n, bool),
            kp_point=np.full(n, -1, np.int32), obs_good=np.zeros(n, bool),
            pyr_data=kd["pyr"], pyr_shapes=kd["shapes"], pyr_dev=pyr_of(kd["pyr"]),
            det_quads=np.stack([d.quad for d in dets]).astype(np.float32),
            det_object=np.full(len(dets), -1, np.int32)), spec["est"][k])
    half = N_KF // 2
    for leg in (range(half), range(half, N_KF)):
        s = 1.0 if leg.start == 0 else spec["sD"]
        seen = {}
        for k in leg:
            for i, w in enumerate(kfs[k]["wid"]):
                if kfs[k]["bind"][i]:
                    seen.setdefault(int(w), []).append((k, i))
        for w, obs in sorted(seen.items()):
            if len(obs) < 2:
                continue
            host, i0 = obs[0]
            p = se3_np.apply(spec["gt"][host], spec["X"][w])
            pid = m.add_point(host, (p / p[2]).astype(np.float32), 1.0 / (s * p[2]),
                              kfs[host]["desc"][i0])
            for k, i in obs:
                m.add_observation(k, i, pid)
        for b, (pi, _, string) in enumerate(spec["world"].boxes):
            obs = [(k, d) for k in leg for d, det in enumerate(kfs[k]["dets"]) if det.text == string]
            if not obs:
                continue
            host, d0 = obs[0]
            theta = torch_synth.plane_theta_in_cam(spec["world"].planes[pi][0],
                                                   spec["gt"][host]) / s
            quad = kfs[host]["dets"][d0].quad
            tid = m.add_text(host, theta.astype(np.float32), quad, string, 0.9, 0,
                             state=state_mod.TEXT_GOOD)
            uv, ref, valid = _features(cfg, kfs[host]["pyr"], kfs[host]["shapes"], quad)
            m.tx_feat_uv[tid], m.tx_feat_ref[tid], m.tx_feat_valid[tid] = uv, ref, valid
            for k, d in obs:
                m.add_text_observation(k, tid, d)
    m.rebuild_covis_m1()
    m.rebuild_covis_m23()
    return m


@pytest.fixture(scope="module")
def spec():
    return _spec()


def _systems(spec, **solver):
    """(JAX side, port side), each (cfg, map, tracker, closer)."""
    out = []
    for mod, st, pyr_of, new_map in (
            (jcfg, jstate, jnp.asarray, jstate.SlamMap),
            (tcfg, tstate, lambda a: torch.tensor(a), lambda c: tstate.SlamMap(c, device="cpu"))):
        cfg = _cfg(mod, **solver)
        m = _build(spec, cfg, st, pyr_of, new_map)
        if mod is jcfg:
            tr = JTracker(cfg, m)
            tr.text_frontend = JTextFrontend(cfg, m, tr)
            lc = jclosing.LoopCloser(cfg, m)
        else:
            tr = TTracker(cfg, m, device="cpu")
            tr.text_frontend = TTextFrontend(cfg, m, tr, device="cpu")
            lc = tclosing.LoopCloser(cfg, m, device="cpu")
        lc.tracker = tr
        out.append((cfg, m, tr, lc))
    return out


def _inject_jax_sets(jlc, tlc):
    """The port's Sim3 RANSAC on the JAX closer's key chain: the same
    3-point sets in the same order."""
    key = [jlc._key]

    def sets(valid):
        key[0], k = jax.random.split(key[0])
        g = jax.random.gumbel(k, (tlc.cfg.loop.sim3_ransac_iters, valid.shape[0]))
        g = jnp.where(jnp.asarray(valid.numpy())[None, :], g, -jnp.inf)
        return torch.tensor(np.asarray(jax.lax.top_k(g, 3)[1]), dtype=torch.int64)

    tlc._ransac_sets = sets


def _kf_state(m):
    return ([kf.kp_point.copy() for kf in m.keyframes], m.pt_valid.copy(), m.pt_bad.copy(),
            m.pt_n_obs.copy(), {p: dict(o) for p, o in m.pt_obs.items()}, dict(m.tx_obs),
            m.tx_inc.copy(), m.tx_valid.copy(), m.tx_state.copy(), m.M1.copy(), m.M2.copy(),
            m.M3.copy(), {k: dict(v) for k, v in m.tx_obs_by_kid.items()},
            {k: dict(v) for k, v in m.tx_obs_by_tid.items()},
            [kf.det_object.copy() for kf in m.keyframes])


def _assert_state_equal(tm, jm):
    for a, b in zip(_kf_state(tm), _kf_state(jm)):
        if isinstance(a, list):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        elif isinstance(a, dict):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)


def test_duplicated_map_built_alike(spec):
    (jc, jm, _, _), (tc, tm, _, _) = _systems(spec)
    assert jm.n_points == tm.n_points > 200 and jm.n_texts == tm.n_texts >= 6
    _assert_state_equal(tm, jm)
    for k in range(N_KF):
        np.testing.assert_array_equal(tm.covisible_prev(k), jm.covisible_prev(k))
        for x, y in zip(tm.covisible_kfs_sorted(k), jm.covisible_kfs_sorted(k)):
            np.testing.assert_array_equal(x, y)
        assert tm.text_obs_of_kf(k) == jm.text_obs_of_kf(k)
    # the legs share no landmark
    assert jm.M1[: N_KF // 2, N_KF // 2:].sum() == 0


def test_replace_and_rebuild(spec):
    (jc, jm, _, _), (tc, tm, _, _) = _systems(spec)
    half = N_KF // 2
    # fuse return-leg points and objects into their first-leg twins (by the
    # world point / string they come from)
    def twins(m):
        by_world, pairs = {}, []
        for pid in range(m.n_points):
            k, i = next(iter(m.pt_obs[pid].items()))
            by_world.setdefault(int(spec["kfs"][k]["wid"][i]), []).append(pid)
        for pids in by_world.values():
            if len(pids) == 2:
                pairs.append((pids[1], pids[0]))
        tpairs = [(t2, t1) for t1 in range(m.n_texts) for t2 in range(m.n_texts)
                  if m.tx_host[t1] < half <= m.tx_host[t2] and m.tx_string[t1] == m.tx_string[t2]]
        return pairs, tpairs
    pairs, tpairs = twins(jm)
    assert twins(tm) == (pairs, tpairs) and len(pairs) > 20 and tpairs
    for m in (jm, tm):
        for a, b in pairs[::2]:
            m.replace_point(a, b)
        for a, b in tpairs:
            m.replace_text(a, b)
        m.rebuild_covis_m1()
        m.rebuild_covis_m23()
    _assert_state_equal(tm, jm)
    assert jm.M1[: half, half:].sum() > 0  # the legs are bridged
    for m in (jm, tm):
        m.rebuild_text_obs_index()
    _assert_state_equal(tm, jm)


@pytest.fixture(scope="module")
def closed(spec):
    """Both packages close the loop of the newest keyframe: detect,
    compute_sim3 per candidate (port RANSAC on the JAX sets), correct with
    the pose graph, global BA and landmark-only BA captured."""
    (jc, jm, jtr, jlc), (tc, tm, ttr, tlc) = _systems(spec)
    _inject_jax_sets(jlc, tlc)
    kid = N_KF - 1
    rec = {"thresh": (jlc._thresh_words(kid), tlc._thresh_words(kid))}
    thresh, connects, _ = rec["thresh"][0]
    min_words = max(int(np.floor(jc.loop.thresh_words_scale * thresh)), jc.loop_thmin_match_words)
    rec["cands"] = (jlc.detect(kid, min_words, connects), tlc.detect(kid, min_words, connects))
    rec["sim3"] = [(jlc.compute_sim3(kid, c), tlc.compute_sim3(kid, c)) for c in rec["cands"][0]]
    res = [r for r in rec["sim3"] if r[0] is not None]
    best = max(range(len(res)), key=lambda i: res[i][0][2])
    cand = [c for c, r in zip(rec["cands"][0], rec["sim3"]) if r[0] is not None][best]
    S_cl, pairs = res[best][0][0], res[best][0][1]

    captured = {}
    jpg, tpg = jclosing.sim3_opt.solve_pose_graph, tclosing.sim3_opt.solve_pose_graph
    jsolve, tsolve = jtr._solve, ttr._solve
    jfused, tfused = jtext.fused_ba_schedule, ttext.fused_ba_schedule

    def cap(side, name, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            captured.setdefault((side, name), []).append((a, k, out))
            return out
        return wrapped

    jclosing.sim3_opt.solve_pose_graph = cap("jax", "pg", jpg)
    tclosing.sim3_opt.solve_pose_graph = cap("port", "pg", tpg)
    jtr._solve, ttr._solve = cap("jax", "solve", jsolve), cap("port", "solve", tsolve)
    jtext.fused_ba_schedule = cap("jax", "fused", jfused)
    ttext.fused_ba_schedule = cap("port", "fused", tfused)
    try:
        jlc.correct(kid, cand, S_cl, copy.deepcopy(pairs))
        tlc.correct(kid, cand, S_cl, copy.deepcopy(pairs))
    finally:
        jclosing.sim3_opt.solve_pose_graph, tclosing.sim3_opt.solve_pose_graph = jpg, tpg
        jtext.fused_ba_schedule, ttext.fused_ba_schedule = jfused, tfused
    rec.update(captured=captured, jm=jm, tm=tm, tc=tc, cand=cand)
    return rec


def test_detect_and_compute_sim3(closed):
    (j, t) = closed["thresh"]
    assert t == j and j[2]
    assert closed["cands"][1] == closed["cands"][0] and closed["cands"][0]
    assert closed["cand"] < N_KF // 2  # the first leg's twin of the newest KF
    n_ok = 0
    for rj, rt in closed["sim3"]:
        assert (rj is None) == (rt is None)
        if rj is None:
            continue
        n_ok += 1
        np.testing.assert_allclose(rt[0], rj[0], rtol=1e-4, atol=1e-4)
        assert rt[1] == rj[1] and rt[2:] == rj[2:]
    assert n_ok >= 1


def test_correct_pose_graph(closed):
    cap = closed["captured"]
    (ja, _, jout), = cap[("jax", "pg")]
    (ta, _, tout), = cap[("port", "pg")]
    jg, tg = ja[0], ta[0]
    for f in ("fixed", "edge_a", "edge_b", "edge_valid"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)), err_msg=f)
    for f in ("nodes", "edge_meas", "edge_weight"):
        np.testing.assert_allclose(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    assert len(jg.edge_a) > N_KF
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), rtol=1e-4, atol=1e-4)


def test_correct_global_ba_by_cost(closed):
    cap = closed["captured"]
    (_, _, jst), = [c for c in cap[("jax", "solve")]][:1]
    (_, _, tst), = [c for c in cap[("port", "solve")]][:1]
    np.testing.assert_allclose(float(tst.cost), float(jst.cost), rtol=1e-3)


def _level0_cost(args, kw, poses, rho, theta):
    """The port's joint cost (scene + text rows, level 0, mu / sigma at the
    given estimate) of a landmark-BA problem at (poses, rho, theta)."""
    costs = []
    orig = tba._solve_ba_body

    def rec(*a, **k):
        st = orig(*a, **k)
        costs.append(float(st.cost))
        return st

    prob = args[0]._replace(poses=torch.tensor(poses), rho=torch.tensor(rho),
                            theta=torch.tensor(theta))
    lv = [a[-1:] for a in args[8:12]]
    tba._solve_ba_body = rec
    try:
        ttext.fused_ba_schedule(prob, *args[1:8], *lv, *args[12:16],
                                **dict(kw, levels=(0,), n_iters=0, gate=False))
    finally:
        tba._solve_ba_body = orig
    return costs[0]


def test_correct_landmark_ba_by_cost(closed):
    cap = closed["captured"]
    (ja, jk, jout), = cap[("jax", "fused")]
    (ta, tk, tout), = cap[("port", "fused")]
    assert jk["no_free_poses"] and tk["no_free_poses"] and jk["levels"] == tk["levels"] == (1, 0)
    for k in ("levels", "n_iters", "huber_scene", "huber_text", "gate"):
        assert tk[k] == jk[k], k
    K, P = ta[0].poses.shape[0], ta[0].rho.shape[0]
    O, T = ta[0].scene.tgt.shape[0], ta[0].theta.shape[0]
    np.testing.assert_allclose(ta[0].rho.numpy(), np.asarray(ja[0].rho), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ta[0].theta.numpy(), np.asarray(ja[0].theta), rtol=1e-4, atol=1e-5)

    def split(packed):
        p = np.asarray(packed)
        return (p[: K * 7].reshape(K, 7), p[K * 7: K * 7 + P],
                p[K * 7 + P + O: K * 7 + P + O + T * 3].reshape(T, 3))

    c_j = _level0_cost(ta, tk, *split(jout))
    c_t = _level0_cost(ta, tk, *split(tout.numpy()))
    c_0 = _level0_cost(ta, tk, ta[0].poses.numpy(), ta[0].rho.numpy(), ta[0].theta.numpy())
    assert c_j < c_0 and c_t < c_0
    np.testing.assert_allclose(c_t, c_j, rtol=1e-3)


def test_correct_fusion_state(closed):
    """The fusions of correct (Sim3 pairs, SearchAndFuse of points and text
    objects) leave both maps with the same landmarks and covisibility."""
    jm, tm = closed["jm"], closed["tm"]
    for name in ("pt_valid", "pt_bad", "tx_valid", "tx_state", "M1", "M2", "M3"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)
    assert set(tm.tx_obs) == set(jm.tx_obs)
    half = N_KF // 2
    assert (~jm.pt_valid[: jm.n_points]).sum() > 20 and (~jm.tx_valid[: jm.n_texts]).sum() >= 1
    assert jm.M1[:half, half:].sum() > 0


def test_landmark_theta_pass(spec):
    """The decomposed landmark pass (global_decompose_kfs lowered): the
    chunked per-object theta solves agree to 1e-3 relative."""
    (jc, jm, jtr, _), (tc, tm, ttr, _) = _systems(spec, landmark_chunk_kfs=4,
                                                  global_decompose_kfs=4)
    n = (jtr.text_frontend.landmark_theta_pass(), ttr.text_frontend.landmark_theta_pass())
    assert n[1] == n[0] >= 4
    np.testing.assert_allclose(tm.tx_theta[: tm.n_texts], jm.tx_theta[: jm.n_texts],
                               rtol=1e-3, atol=1e-6)


def test_landmark_ba_on_the_card_map():
    """chip_smoke.py phase 7's landmark-only BA at full size, on the map the
    port built on the card just before it (tests/loop_card_map.pkl.gz,
    written by tests/loop_correct_compare.py --write-test-map 1 from a
    chip_loop_dump.py run): 640x480 keyframes, the default schedule (levels
    3..0 x 50 iterations). Both packages leave the same GOOD objects outside
    the text bars (a 2-view CAFE0 box of ~26x12 px, whose plane the level-3
    pass moves off), and the other objects' normals agree with each other's
    to 2e-3 in cos against ground truth."""
    import loop_correct_compare as lcc

    with gzip.open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "loop_card_map.pkl.gz"), "rb") as f:
        step = pickle.load(f)
    state = step["map"]
    levels = max(lcc.configs()[1].pyramid.init_ba_levels) + 1
    (jm, jtr, _), (tm, ttr, _) = lcc.systems(state, lcc.pyramids(state, levels))
    args, kw = step["args"]
    assert kw["landmark_only"] and kw["fix"] == kw["window_kids"]
    for tr in (jtr, ttr):
        tr._local_ba(*copy.deepcopy(args), **copy.deepcopy(kw))
    world, gt = lcc.world_and_path()
    pj, pt = lcc.planes(jm, gt, world), lcc.planes(tm, gt, world)
    assert set(pt) == set(pj) and len(pj) >= 6
    miss = {t for t, p in pj.items() if not p[3] > p[4]}
    assert {t for t, p in pt.items() if not p[3] > p[4]} == miss
    assert miss and all(pj[t][0] == "CAFE0" and pj[t][1] == 2 for t in miss)
    for t in set(pj) - miss:
        assert abs(pt[t][3] - pj[t][3]) < 2e-3, (t, pt[t], pj[t])


def test_imports_load_no_jax():
    """The port's modules import no jax, nothing of the JAX package, and no
    cv2 or PIL (the GPU machine has none of them)."""
    code = ("import sys; import textslam_tpu_torch.system, textslam_tpu_torch.loop.closing, "
            "textslam_tpu_torch.cli, textslam_tpu_torch.io.dataset, textslam_tpu_torch.io.png, "
            "textslam_tpu_torch.mapper.checkpoint, textslam_tpu_torch.native; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'textslam_tpu', 'cv2', 'PIL')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
