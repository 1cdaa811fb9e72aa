"""The text slice end to end: the port's TextSLAM with the default text
pipeline against the JAX package's, on one rendered text-world sequence
(the lateral path at 320x240 with K halved, 500 / 1500 ORB features, the
default text configuration otherwise).

Two comparisons:
- From identical state. The JAX system runs until it initializes; its map
  (slam_map_from_numpy), tracker state and text-frontend state
  (text_frontend_from_numpy) go into the port, and from then on both
  trackers are fed the same keypoints, pyramids and detections (the JAX
  frames'), so ORB's and the pyramid's summation-order differences stay out.
  Theta RANSAC draws from the JAX key chain in both (the hypothesis sets are
  injected: torch cannot reproduce the JAX PRNG). On every tracked frame
  without a keyframe the whole per-frame path (track step, gates, joint
  scene+text pose refinement, IMMATURE maturation, KLT) must agree: pose to
  1e-4, text states and the good/bad/maturation counters (the gate
  decisions) exactly, thetas to 1e-3 relative (the maturation runs 33 LM
  builds in float32). At a keyframe the windowed
  joint BA must receive the same inputs (to 1e-4 relative: the depths of
  the points triangulated there come from a float32 SVD); its LM path then legitimately
  diverges (seen on this sequence: on the first 3-keyframe window JAX
  accepts a step at lambda 1e-4 that the port rejects by a hair, and one
  step later the port reaches the lower cost; the window's scale direction
  is held only by damping), so after each keyframe
  the port is re-synchronized from JAX's state and the comparison goes on.
- From scratch. The port runs alone through `track_monocular` and is held
  against ground truth: keyframe ATE < 0.03 and every GOOD object's plane
  normal within cos > 0.9 of the true plane.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textslam_tpu import config as jcfg
from textslam_tpu.frontend import text as jtext
from textslam_tpu.frontend.frame import TextDetection as JDet
from textslam_tpu.frontend.frame import build_frame as jbuild_frame
from textslam_tpu.frontend.frame import ensure_host_kp as jensure_host_kp
from textslam_tpu.system import TextSLAM as JaxSLAM
from textslam_tpu_torch import config as tcfg
from textslam_tpu_torch.frontend import text as ttext
from textslam_tpu_torch.frontend.frame import Frame, build_frame
from textslam_tpu_torch.frontend.text import text_frontend_from_numpy
from textslam_tpu_torch.frontend.tracking import Tracker
from textslam_tpu_torch.mapper.state import TEXT_GOOD, slam_map_from_numpy
from textslam_tpu_torch.solver import ba as tba
from textslam_tpu_torch.system import TextSLAM

import torch_synth

torch.set_num_threads(2)

N_FRAMES = 10


def _cfg(mod):
    return mod.TextSLAMConfig(
        camera=mod.CameraConfig(fx=210.0, fy=210.0, cx=160.0, cy=120.0,
                                width=320, height=240, fps=10.0),
        orb=mod.ORBConfig(n_features=500, n_features_init=1500),
    )


@pytest.fixture(scope="module")
def sequence():
    K = torch_synth.K.copy()
    K[:2] /= 2
    return torch_synth.render_text_sequence(N_FRAMES, K_mat=K, size=(320, 240))


def _cos(a, b):
    return float(abs(np.dot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def _handover(js, tslam, key):
    """Copy JAX's map, tracker and text-frontend state into the port (the
    KLT tracks of the newest keyframe's unmapped boxes are seeded again from
    the copied map, as JAX seeded them)."""
    jt, jtf, tt = js.tracker, js.tracker.text_frontend, tslam.tracker
    tslam.map = tt.map = slam_map_from_numpy(vars(js.map), tslam.cfg, device="cpu")
    for k in ("state", "velocity", "last_pose", "prev_pose", "last_kf_frame_id",
              "n_tracked_last_kf"):
        v = getattr(jt, k)
        setattr(tt, k, v.copy() if isinstance(v, np.ndarray) else v)
    tf = text_frontend_from_numpy(vars(jtf), tslam.cfg, tslam.map, tt, device="cpu")
    tt.text_frontend = tf
    if jtf._klt is not None:
        tf.seed_new_text_tracks(jtf._klt["host_kid"])
    # theta RANSAC on the JAX key chain (injected hypothesis sets)
    key[0] = jtf._key

    def ransac(rays, rhos, valid):
        key[0], k = jax.random.split(key[0])
        th, _, ok = jtext._theta_ransac_kernel(k, jnp.asarray(rays), jnp.asarray(rhos),
                                               jnp.asarray(valid))
        return np.asarray(th), bool(ok)

    tf._theta_ransac = ransac
    return tf


def _snapshot(m):
    n = m.n_texts
    return dict(n_kf=len(m.keyframes), n_points=m.n_points, n_texts=n,
                strings=list(m.tx_string[:n]), state=m.tx_state[:n].copy(),
                theta=m.tx_theta[:n].copy(), good=m.tx_good_obs[:n].copy(),
                bad=m.tx_bad_obs[:n].copy(), obvs=m.tx_num_obvs[:n].copy())


@pytest.fixture(scope="module")
def lockstep(sequence):
    frames, dets, _, _ = sequence
    js = JaxSLAM(_cfg(jcfg))
    tslam = TextSLAM(_cfg(tcfg), device="cpu")
    jt = js.tracker

    def jax_frame(i):
        n = js.cfg.orb.n_features if jt.state == 1 else js.cfg.orb.n_features_init
        jd = [JDet(quad=d.quad, text=d.text, score=d.score) for d in dets[i]]
        f = jbuild_frame(js.cfg, frames[i], i, float(i), detections=jd, n_features=n)
        jensure_host_kp(f)
        return f

    def port_frame(jf):
        return Frame(frame_id=jf.frame_id, timestamp=jf.timestamp, shape=jf.shape,
                     kp_uv=jf.kp_uv, kp_level=jf.kp_level, kp_angle=jf.kp_angle,
                     kp_desc=jf.kp_desc, kp_valid=jf.kp_valid,
                     pyr_shapes=np.asarray(jf.pyr_shapes),
                     pyr_dev=torch.tensor(np.asarray(jf.pyr_dev)),
                     detections=dets[jf.frame_id])

    i = 0
    while jt.state != 1 and i < 5:
        jt.process(jax_frame(i))
        i += 1
    init_frame = i - 1
    key = [None]
    _handover(js, tslam, key)
    handover = dict(jax=_snapshot(js.map), port=_snapshot(tslam.map),
                    arrays={k: (getattr(js.map, k).copy(), getattr(tslam.map, k).copy())
                            for k in ("tx_feat_uv", "tx_feat_ref", "tx_feat_valid", "M2", "M3")})
    # the windowed BA's inputs, captured on both sides
    ba_in = {}
    jorig, torig = jtext.fused_ba_schedule, ttext.fused_ba_schedule

    def capture(side, fn):
        def wrapped(*a, **k):
            ba_in[side] = (a, k)
            return fn(*a, **k)
        return wrapped

    jtext.fused_ba_schedule = capture("jax", jorig)
    ttext.fused_ba_schedule = capture("port", torig)
    records = []
    try:
        for j in range(i, N_FRAMES):
            jf = jax_frame(j)
            pf = port_frame(jf)
            n_kf = len(js.map.keyframes)
            ba_in.clear()
            ok = (jt.process(jf), tslam.tracker.process(pf))
            rec = dict(frame=j, ok=ok, pose=(jf.pose.copy(), pf.pose.copy()),
                       kf_inserted=len(js.map.keyframes) > n_kf,
                       rows=(jt.text_frontend.last_text_rows,
                             tslam.tracker.text_frontend.last_text_rows),
                       jax=_snapshot(js.map), port=_snapshot(tslam.map), ba_inputs=dict(ba_in))
            records.append(rec)
            if rec["kf_inserted"]:
                _handover(js, tslam, key)
    finally:
        jtext.fused_ba_schedule, ttext.fused_ba_schedule = jorig, torig
    return init_frame, handover, records, js, tslam


def test_handover_is_exact(lockstep):
    _, handover, _, _, _ = lockstep
    assert handover["port"]["n_texts"] >= 1
    for k, v in handover["jax"].items():
        np.testing.assert_array_equal(handover["port"][k], v, err_msg=k)
    for k, (a, b) in handover["arrays"].items():
        np.testing.assert_array_equal(b, a, err_msg=k)


def _tracked(records):
    return [r for r in records if not r["kf_inserted"]]


def test_lockstep_per_frame_path(lockstep):
    """Frames without a keyframe: the whole per-frame path agrees."""
    init_frame, _, records, _, _ = lockstep
    assert init_frame <= 4
    assert len(_tracked(records)) >= 4
    assert any(r["rows"][0] > 0 for r in records)  # the text pose refinement ran
    assert any(r["jax"]["obvs"].sum() > 0 for r in records)  # and the maturation
    for r in _tracked(records):
        j, t = r["jax"], r["port"]
        assert r["ok"] == (True, True), r["frame"]
        assert r["rows"][0] == r["rows"][1], r["frame"]
        for k in ("n_kf", "n_points", "n_texts", "strings"):
            assert j[k] == t[k], (r["frame"], k)
        for k in ("state", "good", "bad", "obvs"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=f"{k} at frame {r['frame']}")
        pj, pt = r["pose"]
        np.testing.assert_allclose(pt, pj, atol=1e-4, err_msg=str(r["frame"]))
        # IMMATURE thetas come out of 3 levels x 11 LM builds in float32
        np.testing.assert_allclose(t["theta"], j["theta"], rtol=1e-3, atol=1e-6,
                                   err_msg=str(r["frame"]))


def test_lockstep_keyframe_ba_inputs(lockstep):
    """At each keyframe the windowed joint BA receives identical inputs
    (scene rows, text pairs and rows, per-level features and image stacks);
    triangulation before it agrees exactly."""
    _, _, records, _, _ = lockstep
    kf_records = [r for r in records if r["kf_inserted"]]
    assert kf_records
    checked = 0
    for r in kf_records:
        assert r["ok"] == (True, True), r["frame"]
        assert r["jax"]["n_kf"] == r["port"]["n_kf"] and r["jax"]["n_points"] == r["port"]["n_points"]
        if "jax" not in r["ba_inputs"]:
            continue  # no text pair in the window: a scene-only solve
        checked += 1
        (ja, jk), (ta, tk) = r["ba_inputs"]["jax"], r["ba_inputs"]["port"]
        for k in ("levels", "n_iters", "huber_scene", "huber_text", "weight_text", "pair_feat",
                  "gate", "no_free_poses"):
            assert jk[k] == tk[k], k
        jp, tp = ja[0], ta[0]
        # depths of the points triangulated at this keyframe: a float32 SVD
        for f in ("poses", "pose_free", "rho", "rho_free", "theta", "theta_free"):
            np.testing.assert_allclose(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)),
                                       rtol=1e-4, atol=1e-6, err_msg=f)
        for f in jp.scene._fields:
            np.testing.assert_allclose(getattr(tp.scene, f).numpy(),
                                       np.asarray(getattr(jp.scene, f)), rtol=1e-5, atol=1e-6,
                                       err_msg=f)
        for k in ja[1]:
            np.testing.assert_array_equal(ta[1][k].numpy(), np.asarray(ja[1][k]), err_msg=k)
        for a, b in zip(ja[2:12], ta[2:12]):
            for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
                np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    assert checked >= 1


def test_covisibility_matches(lockstep):
    """After the last frame (a re-synchronized or per-frame state), the text
    observation registries and the M2/M3 covisibility agree."""
    _, _, records, js, tslam = lockstep
    assert set(tslam.map.tx_obs) == set(js.map.tx_obs)
    for name in ("M1", "M2", "M3"):
        np.testing.assert_array_equal(getattr(tslam.map, name), getattr(js.map, name))


def test_port_from_scratch(sequence):
    frames, dets, gt, world = sequence
    slam = TextSLAM(_cfg(tcfg), device="cpu")
    for i, img in enumerate(frames):
        slam.track_monocular(img, float(i), detections=dets[i])
    m = slam.map
    assert slam.tracker.state == 1
    assert len(slam.tracker.trajectory) >= N_FRAMES - 4
    kfs = m.keyframes
    kf_ate = torch_synth.ate_rmse([kf.timestamp for kf in kfs],
                                  np.stack([m.kf_pose[kf.kid] for kf in kfs]), gt)
    assert kf_ate < 0.03, kf_ate
    good = [t for t in range(m.n_texts) if m.tx_state[t] == TEXT_GOOD]
    assert m.n_texts >= 2 and good
    for tid in good:
        box = next(b for b in world.boxes if b[2] == m.tx_string[tid])
        th_gt = torch_synth.plane_theta_in_cam(world.planes[box[0]][0],
                                               gt[m.keyframes[int(m.tx_host[tid])].frame_id])
        assert _cos(m.tx_theta[tid], th_gt) > 0.9, (tid, m.tx_string[tid])
    # the windowed BA's text rows all sampled inside their regions
    assert m.M2[: len(kfs), : len(kfs)].sum() > 0


def test_unported_paths_raise(tmp_path):
    """Every path is ported now. With text on, ba_devices=2 builds the
    tracker's 2-shard CPU mesh (tests/test_torch_e2e_mesh.py runs it).
    Checkpointing: a checkpoint carries the text frontend's and the loop
    closer's RANSAC generator states, and a loaded system continues both
    streams."""
    cfg = _cfg(tcfg)
    meshed = TextSLAM(dataclasses.replace(cfg, parallel=tcfg.ParallelConfig(ba_devices=2)),
                      device="cpu")
    assert meshed.tracker.mesh.size == 2 and meshed.tracker.text_frontend is not None
    slam = TextSLAM(cfg, device="cpu")
    gens = (slam.tracker.text_frontend._gen, slam.loop_closer._gen)
    for g in gens:
        torch.rand(5, generator=g)
    path = str(tmp_path / "text.npz")
    slam.save_checkpoint(path)
    loaded = TextSLAM(cfg, device="cpu")
    loaded.load_checkpoint(path)
    for g, h in zip(gens, (loaded.tracker.text_frontend._gen, loaded.loop_closer._gen)):
        assert torch.equal(torch.rand(3, generator=g), torch.rand(3, generator=h))


@pytest.mark.parametrize("no_text", [False, True])
def test_keyframe_hook_runs_loop_closer(no_text):
    """With text on, every new keyframe runs the loop closer once (JAX
    system.py:38-41); the closer does no work below its two keyframe gates
    and starts (the word threshold) once past them, in the default
    configuration (20 keyframes) too. Under noText it never runs."""
    for cfg in (_cfg(tcfg), tcfg.TextSLAMConfig()):
        cfg = dataclasses.replace(cfg, no_text=no_text)
        slam = TextSLAM(cfg, device="cpu")
        lc = slam.loop_closer
        runs, started = [], []
        run = lc.run
        lc.run = lambda kid: runs.append(kid) or run(kid)
        lc._thresh_words = lambda kid: started.append(kid) or (-1, set(), False)
        n = cfg.loop.min_kfs_before_loop
        slam.map.keyframes = [None] * (n - 1)
        slam._on_keyframe(n - 2)  # below the gate: no work
        slam.map.keyframes = [None] * n
        slam._on_keyframe(n - 1)  # past both gates
        lc.last_loop_kid = n - 1
        slam._on_keyframe(n)  # within min_kfs_between_loops of the last loop
        if no_text:
            assert runs == [] and started == []
        else:
            assert runs == [n - 2, n - 1, n] and started == [n - 1]


def test_entry_points_refuse_cuda_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal cannot be shown here")
    cfg = _cfg(tcfg)
    with pytest.raises(RuntimeError, match="GPU"):
        TextSLAM(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="GPU"):
        Tracker(cfg, None, device="cuda")
    with pytest.raises(RuntimeError, match="GPU"):
        build_frame(cfg, np.zeros((240, 320), np.float32), 0, 0.0, device="cuda")
    with pytest.raises(RuntimeError, match="GPU"):
        tba.ba_problem_from_numpy({"poses": np.zeros((1, 7))}, device="cuda")
    with pytest.raises(RuntimeError, match="GPU"):
        slam_map_from_numpy({}, cfg, device="cuda")
    # and none of them has a device default
    for fn in (Tracker, build_frame, tba.ba_problem_from_numpy, slam_map_from_numpy):
        with pytest.raises(TypeError):
            fn(*([cfg, None] if fn is Tracker else [cfg, np.zeros((8, 8), np.float32), 0, 0.0]
                 if fn is build_frame else [{}] if fn is tba.ba_problem_from_numpy else [{}, cfg]))
