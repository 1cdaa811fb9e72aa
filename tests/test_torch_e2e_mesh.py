"""The port's whole pipeline on a device mesh: TextSLAM with
ParallelConfig(ba_devices=4), whose Tracker._local_ba solves every windowed
BA with the sharded LM (parallel.ba_sharded.solve_ba_sharded) on 4 CPU
shards, as tests/test_e2e_mesh.py runs the JAX package on its 8-device mesh.
Sequences: the lateral path at 320x240 with K halved and 500 / 1500 ORB
features (16 scene frames; 10 text frames with detections).

- Scene only: keyframe poses within 5e-3 of the single-device run (the
  bar of tests/test_e2e_mesh.py: reassociated sums compound through the
  pipeline's discrete gates), keyframe ATE < 0.012 and within 0.002 of the
  single-device run's, and the sharded solver called.
- Text: the mesh branch of _local_ba runs (sharded solves carrying text
  rows are counted), the run tracks and keeps its text objects; from one
  state, the mesh branch builds every level's text rows exactly as the
  single-device fused schedule does, and solves them with the
  single-device LM (exactly on one shard; the first build's cost to 1e-5
  on four); visible_texts equals the JAX package's
  TextJudge gates on the same pool.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from textslam_tpu.frontend import text as jtext
from textslam_tpu_torch import config as tcfg
from textslam_tpu_torch.mapper.state import TEXT_GOOD
from textslam_tpu_torch.parallel import ba_sharded
from textslam_tpu_torch.system import TextSLAM

import torch_synth

torch.set_num_threads(2)


def _cfg(ba_devices: int, no_text: bool):
    return tcfg.TextSLAMConfig(
        no_text=no_text,
        camera=tcfg.CameraConfig(fx=210.0, fy=210.0, cx=160.0, cy=120.0, width=320, height=240,
                                 fps=10.0),
        orb=tcfg.ORBConfig(n_features=500, n_features_init=1500),
        parallel=tcfg.ParallelConfig(ba_devices=ba_devices),
    )


def _small_k():
    K = torch_synth.K.copy()
    K[:2] /= 2
    return K


class _Spy:
    """Counts solve_ba_sharded calls, and those carrying text rows."""

    def __init__(self, monkeypatch):
        self.n = self.with_text = 0
        orig = ba_sharded.solve_ba_sharded

        def spy(prob, mesh, **kw):
            self.n += 1
            self.with_text += prob.text is not None
            return orig(prob, mesh, **kw)

        monkeypatch.setattr(ba_sharded, "solve_ba_sharded", spy)


def _run(cfg, frames, dets=None):
    slam = TextSLAM(cfg, device="cpu")
    for i, img in enumerate(frames):
        slam.track_monocular(img, float(i), detections=None if dets is None else dets[i])
    return slam


def _kf_poses(slam):
    kfs = slam.map.keyframes
    return np.array([kf.timestamp for kf in kfs]), np.stack([slam.map.kf_pose[kf.kid]
                                                             for kf in kfs])


def test_mesh_from_config():
    slam = TextSLAM(_cfg(2, no_text=False), device="cpu")
    assert slam.tracker.mesh is not None and slam.tracker.mesh.size == 2
    assert TextSLAM(_cfg(0, no_text=True), device="cpu").tracker.mesh is None


def test_sharded_ba_matches_single_device(monkeypatch):
    frames, gt = torch_synth.render_sequence(16, kind="lateral", K_mat=_small_k(),
                                             size=(320, 240))
    slam1 = _run(_cfg(0, no_text=True), frames)
    spy = _Spy(monkeypatch)
    slam4 = _run(_cfg(4, no_text=True), frames)
    assert slam4.tracker.mesh is not None and slam4.tracker.mesh.size == 4
    assert spy.n > 0, "the sharded solver was never called"
    assert slam4.tracker.state == 1, "the mesh run lost tracking"
    assert len(slam4.map.keyframes) == len(slam1.map.keyframes)
    t1, k1 = _kf_poses(slam1)
    t4, k4 = _kf_poses(slam4)
    np.testing.assert_allclose(k4, k1, atol=5e-3)
    ate1, ate4 = torch_synth.ate_rmse(t1, k1, gt), torch_synth.ate_rmse(t4, k4, gt)
    assert ate4 < 0.012, f"mesh KF ATE {ate4}"
    assert abs(ate4 - ate1) < 0.002, (ate1, ate4)


@pytest.fixture(scope="module")
def text_run():
    frames, dets, gt, world = torch_synth.render_text_sequence(10, K_mat=_small_k(),
                                                               size=(320, 240))
    mp = pytest.MonkeyPatch()
    try:
        spy = _Spy(mp)
        slam = _run(_cfg(4, no_text=False), frames, dets)
    finally:
        mp.undo()
    return slam, spy, gt


def test_sharded_ba_with_text_in_pipeline(text_run):
    slam, spy, gt = text_run
    assert slam.tracker.state == 1
    assert spy.n > 0, "the sharded solver was never called"
    assert spy.with_text > 0, "no sharded solve carried text rows"
    m = slam.map
    assert m.n_texts >= 1 and (m.tx_state[: m.n_texts] == TEXT_GOOD).any()
    ts, kp = _kf_poses(slam)
    assert torch_synth.ate_rmse(ts, kp, gt) < 0.03


def test_mesh_branch_solves_the_fused_rows(text_run):
    """From one state, the mesh branch of _local_ba builds at every level
    the text rows and level images that the single-device fused schedule
    builds at the same estimate (build_text_obs / gather_level_images
    against fused_ba_inputs, exactly). Its LM is the single-device LM: on a
    1-shard mesh the sharded solve of those rows equals solve_ba (with the
    same per-feature sampling) exactly, and on the 4-shard mesh the first
    build's cost agrees to 1e-5 relative. Whole solves are not compared:
    this window's LM is far from converged after its 10 iterations and
    ill-conditioned along the scale direction, so the reassociated sums move
    the first step's cost by ~6e-5 relative and the accept / reject path
    parts (final costs seen 2% apart, either side lower)."""
    from textslam_tpu_torch.frontend.text import _level_text_obs
    from textslam_tpu_torch.geometry.camera import unproject
    from textslam_tpu_torch.parallel.mesh import Mesh
    from textslam_tpu_torch.solver import ba

    slam, _, _ = text_run
    s = copy.deepcopy(slam)
    tr, m, tf, sc = s.tracker, s.map, s.tracker.text_frontend, s.cfg.solver
    window = m.window_kfs(sc.ba_window)
    calls = []
    solve = tr._solve

    def spy(prob, **kw):
        st = solve(prob, **kw)
        calls.append((prob, kw, st))
        return st

    tr._solve = spy
    K = 32  # the tracker's pinned window tier
    pairs, tids, tid_to_lm = tf.ba_text_batches(window, {k: i for i, k in enumerate(window)}, K)
    levels = s.cfg.pyramid.ba_levels
    fi = tf.fused_ba_inputs(pairs, tid_to_lm, window, levels, K)
    tr._local_ba(window_kids=window, fix=window[:1])
    assert len(calls) == len(levels) and all(p.text is not None for p, _, _ in calls)
    cam = s.cfg.camera
    qrays = unproject(fi["pair_quads"], cam.fx, cam.fy, cam.cx, cam.cy)
    weight = torch.full((fi["Np"] * s.cfg.text.max_features_per_level,), sc.weight_text)
    for li, (prob, kw, st) in enumerate(calls):
        want = _level_text_obs(prob, fi["rows"], qrays, fi["pair_lm"], fi["pair_tgt"],
                               fi["pair_host"], fi["pair_hiw"], fi["pair_hpose"],
                               fi["feat_uv_lv"][li], fi["ref_lv"][li], fi["fvalid_lv"][li],
                               fi["imgs_lv"][li], levels[li], weight, cam.fx, cam.fy, cam.cx,
                               cam.cy)
        assert prob.text.level == want.level == levels[li]
        for name in ba.TextObs._fields[:-1]:
            assert torch.equal(getattr(prob.text, name), getattr(want, name)), (li, name)
        assert torch.equal(prob.images, fi["imgs_lv"][li])
        kw = dict({k: v for k, v in kw.items() if k != "no_free_poses"},
                  lam0=sc.lm_lambda_init, lam_up=sc.lm_lambda_up, lam_down=sc.lm_lambda_down,
                  lam_min=sc.lm_min_lambda, lam_max=sc.lm_max_lambda)
        one = ba_sharded.solve_ba_sharded(prob, Mesh(["cpu"]), **kw)
        ref = ba.solve_ba(prob, **kw)
        for name in ("poses", "rho", "theta", "lam", "cost"):
            assert torch.equal(getattr(one, name), getattr(ref, name)), (li, name)
        kw["n_iters"] = 0
        c4 = float(ba_sharded.solve_ba_sharded(prob, tr.mesh, **kw).cost)
        c1 = float(ba.solve_ba(prob, **kw).cost)
        assert abs(c4 - c1) <= 1e-5 * max(1.0, c1), (li, c4, c1)


def test_visible_texts_matches_jax_gates(text_run):
    slam, _, _ = text_run
    tf, m, cam = slam.tracker.text_frontend, slam.map, slam.cfg.camera
    frame = slam.tracker.last_frame
    pose = frame.pose
    Tt = 8
    while Tt < m.n_texts:
        Tt *= 2
    quads, thetas, hposes, live, _ = (x.numpy() for x in tf._pool_rows(Tt))
    box = [x.numpy() for x in tf._pool_dev(Tt)[:3]]
    h, w = (int(v) for v in frame.pyr_shapes[0])
    img0 = frame.pyr_dev[0, :h, :w, 0].numpy()
    tc = slam.cfg.text
    geo, full, _ = jtext._gates_kernel(
        jnp.asarray(pose), jnp.asarray(quads), jnp.asarray(thetas), jnp.asarray(hposes),
        jnp.asarray(live), *(jnp.asarray(b) for b in box), jnp.asarray(img0),
        cam.fx, cam.fy, cam.cx, cam.cy, tc.in_image_margin, tc.cos_orientation_min,
        tc.zncc_min, cam.width, cam.height)
    good = m.tx_state[: m.n_texts] == TEXT_GOOD
    want = [t for t in range(m.n_texts) if np.asarray(full)[t] and good[t]]
    assert tf.visible_texts(pose, frame) == want
    want_geo = [t for t in range(m.n_texts) if np.asarray(geo)[t] and good[t]]
    assert tf.visible_texts(pose, None) == want_geo
    assert want, "no object visible: the comparison shows nothing"
