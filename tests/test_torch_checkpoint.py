"""Checkpoint / resume in the port (textslam_tpu_torch.mapper.checkpoint,
TextSLAM.save_checkpoint / load_checkpoint) and across the two packages.

The file format is the JAX package's npz. On one rendered scene-only
sequence (16 frames of the lateral path at 320x240 with K halved, 500 /
1500 ORB features: test_torch_slam's setting):
- tests/test_checkpoint.py's four cases on the port: a run saved at frame
  10 and resumed in a fresh system keeps its map and tracks on (keyframe
  ATE under test_torch_slam's 320x240 bar, 0.03, and the resumed run equal
  to the uninterrupted one); a legacy checkpoint without the newer fields
  loads with pt_n_obs recomputed; the tx_num_obvs backfill; the window
  keyframes' pyramids back on the device, and the map's upload device set.
- JAX -> port: a checkpoint the JAX package saved at frame 10 loads in the
  port with the same arrays and tracker state as the JAX package's own
  load, and the port tracks the remaining frames from it: keyframe ATE
  under test_cli_e2e's 0.05 and within 1e-3 of the JAX package's
  uninterrupted run, keyframe rotations within 0.1 deg of that run's (the
  windowed BA fixes no scale, so scale is not compared: ROADMAP's scale
  gauge).
- port -> JAX: the port's checkpoint loads in the JAX package's load with
  the port's arrays.
- text on, with pyramids: the 640x480 loop-run map of
  tests/loop_card_map.pkl.gz round-trips through both packages.
"""

import copy
import dataclasses
import gzip
import logging
import os
import pickle

import numpy as np
import pytest
import torch

from textslam_tpu import config as jcfg
from textslam_tpu.mapper import checkpoint as jckpt
from textslam_tpu.system import TextSLAM as JaxSLAM
from textslam_tpu_torch import config as tcfg
from textslam_tpu_torch.geometry import se3_np
from textslam_tpu_torch.mapper import checkpoint as tckpt
from textslam_tpu_torch.mapper import state as tstate
from textslam_tpu_torch.system import TextSLAM

import torch_synth

torch.set_num_threads(2)

N_FRAMES, HALF = 16, 10
ATE_320 = 0.03  # tests/test_torch_slam.py's keyframe bar at 320x240
# the port resumed from a JAX checkpoint: tests/test_cli_e2e.py's ATE bar
# (tests/test_checkpoint.py's 0.015 is a 640x480 bar: the JAX package's own
# run on this 320x240 sequence ends at 0.0315), and within ATE_DIFF of the
# JAX package's uninterrupted run
ATE_CLI = 0.05
ATE_DIFF = 1e-3
ROT_DEG = 0.1
MAP_ARRAYS = ("kf_pose", "kf_valid") + tckpt._MAP_FIELDS + ("tx_inc",)
KF_ARRAYS = ("kp_uv", "kp_level", "kp_angle", "kp_desc", "kp_valid", "kp_point", "obs_good",
             "pyr_data", "pyr_shapes", "det_quads", "det_object")


def _cfg(mod, **kw):
    return mod.TextSLAMConfig(
        no_text=True,
        camera=mod.CameraConfig(fx=210.0, fy=210.0, cx=160.0, cy=120.0,
                                width=320, height=240, fps=10.0),
        orb=mod.ORBConfig(n_features=500, n_features_init=1500), **kw)


@pytest.fixture(scope="module")
def sequence():
    K = torch_synth.K.copy()
    K[:2] /= 2
    return torch_synth.render_sequence(N_FRAMES, K_mat=K, size=(320, 240))


def _kf_ate(m, gt):
    kfs = m.keyframes
    return torch_synth.ate_rmse([kf.timestamp for kf in kfs],
                                np.stack([m.kf_pose[kf.kid] for kf in kfs]), gt)


def assert_same_state(a, b, tracker_a=None, tracker_b=None):
    """Two maps (either package) hold the same state: pools, counters,
    strings, observation registries and indexes, keyframe records; and
    two trackers the same motion state."""
    for name in MAP_ARRAYS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    assert (a.n_points, a.n_texts) == (b.n_points, b.n_texts)
    assert a.tx_string[:a.n_texts] == b.tx_string[:b.n_texts]
    for name in ("pt_obs", "tx_obs", "tx_obs_by_kid", "tx_obs_by_tid", "tx_obs_good"):
        assert getattr(a, name) == getattr(b, name), name
    assert a.tx_feat_good.keys() == b.tx_feat_good.keys()
    for k in a.tx_feat_good:
        np.testing.assert_array_equal(a.tx_feat_good[k], b.tx_feat_good[k])
    assert len(a.keyframes) == len(b.keyframes)
    for ka, kb in zip(a.keyframes, b.keyframes):
        assert (ka.kid, ka.frame_id, ka.timestamp, ka.loop_edges) == \
            (kb.kid, kb.frame_id, kb.timestamp, kb.loop_edges)
        for name in KF_ARRAYS:
            va, vb = getattr(ka, name), getattr(kb, name)
            assert (va is None) == (vb is None), name
            if va is not None:
                np.testing.assert_array_equal(va, vb, err_msg=name)
        assert [(d.text, d.score, d.lang) for d in ka.det_text or []] == \
            [(d.text, d.score, d.lang) for d in kb.det_text or []]
    if tracker_a is not None:
        for name in ("state", "last_kf_frame_id", "n_tracked_last_kf"):
            assert int(getattr(tracker_a, name)) == int(getattr(tracker_b, name)), name
        np.testing.assert_array_equal(tracker_a.last_pose, tracker_b.last_pose)
        np.testing.assert_array_equal(tracker_a.velocity, tracker_b.velocity)
        assert len(tracker_a.trajectory) == len(tracker_b.trajectory)
        for (ta, pa), (tb, pb) in zip(tracker_a.trajectory, tracker_b.trajectory):
            assert ta == tb
            np.testing.assert_array_equal(pa, pb)


@pytest.fixture(scope="module")
def port_run(sequence, tmp_path_factory):
    """The port over the whole sequence, with a checkpoint at HALF: (the
    checkpoint's path, the system at the end of the sequence)."""
    frames, _ = sequence
    slam = TextSLAM(_cfg(tcfg), device="cpu")
    path = str(tmp_path_factory.mktemp("ckpt") / "port.npz")
    for i in range(HALF):
        slam.track_monocular(frames[i], float(i))
    assert slam.tracker.state == 1
    slam.save_checkpoint(path, extra={"frame_index": HALF - 1})
    for i in range(HALF, len(frames)):
        slam.track_monocular(frames[i], float(i))
    return path, slam


def test_save_load_resume(port_run, sequence):
    frames, gt = sequence
    path, full = port_run
    slam = TextSLAM(_cfg(tcfg), device="cpu")
    extra = slam.load_checkpoint(path)
    assert extra["frame_index"] == HALF - 1 and slam.frame_count == HALF
    ref, _ = tckpt.load(path, _cfg(tcfg), device="cpu")
    assert_same_state(slam.map, ref)
    n = slam.map.n_points
    assert slam.map.pt_n_obs[:n].max() >= 2
    assert slam.tracker.map is slam.map and slam.loop_closer.map is slam.map
    for i in range(HALF, len(frames)):
        slam.track_monocular(frames[i], float(i))
    assert slam.tracker.state == 1
    assert _kf_ate(slam.map, gt) < ATE_320
    # the resumed run is the uninterrupted one
    np.testing.assert_array_equal(slam.map.kf_pose, full.map.kf_pose)
    assert [t for t, _ in slam.tracker.trajectory] == [t for t, _ in full.tracker.trajectory]


def test_legacy_checkpoint_missing_fields(port_run, tmp_path):
    path, _ = port_run
    cfg = _cfg(tcfg)
    want, _ = tckpt.load(path, cfg, device="cpu")
    z = dict(np.load(path, allow_pickle=False))
    for k in ("pt_n_obs", "pt_desc_latest", "pt_desc_second", "tx_sem_score"):
        z.pop(k)
    legacy = str(tmp_path / "legacy.npz")
    np.savez_compressed(legacy, **z)
    m, _ = tckpt.load(legacy, cfg, device="cpu")
    n = want.n_points
    np.testing.assert_array_equal(m.pt_n_obs[:n], want.pt_n_obs[:n])
    np.testing.assert_array_equal(m.pt_desc_latest[:n], m.pt_desc[:n])
    assert np.isinf(m.tx_sem_score).all()


def test_legacy_checkpoint_backfills_tx_num_obvs(tmp_path):
    cfg = _cfg(tcfg)
    m = tstate.SlamMap(cfg, device="cpu")
    t_good = m.add_text(0, np.array([0, 0, -0.5], np.float32), np.zeros((4, 2), np.float32),
                        "EXIT", 0.9, 0, state=tstate.TEXT_GOOD)
    t_imm = m.add_text(0, np.array([0, 0, -0.5], np.float32), np.zeros((4, 2), np.float32),
                       "CAFE", 0.9, 0, state=tstate.TEXT_IMMATURE)
    m.tx_good_obs[[t_good, t_imm]] = 1, 3
    m.tx_num_obvs[[t_good, t_imm]] = 9, 3
    path = str(tmp_path / "map.npz")
    tckpt.save(path, m)
    z = dict(np.load(path, allow_pickle=False))
    z.pop("tx_num_obvs")
    np.savez_compressed(path, **z)
    m2, _ = tckpt.load(path, cfg, device="cpu")
    assert m2.tx_num_obvs[t_imm] == 3
    assert m2.tx_num_obvs[t_good] >= cfg.text.min_obs_promote


def test_resume_restores_window_pyr_dev(tmp_path):
    """The last ba_window + 8 keyframes' pyramids go back on the device, and
    the map uploads older ones there too."""
    cfg = dataclasses.replace(_cfg(tcfg), solver=tcfg.SolverConfig(ba_window=1))
    m = tstate.SlamMap(cfg, device="cpu")
    for k in range(12):
        m.add_keyframe(tstate.Keyframe(
            kid=k, frame_id=k, timestamp=float(k), kp_uv=np.zeros((4, 2), np.float32),
            kp_level=np.zeros(4, np.int32), kp_angle=np.zeros(4, np.float32),
            kp_desc=np.zeros((4, 8), np.uint32), kp_valid=np.ones(4, bool),
            kp_point=np.full(4, -1, np.int32), obs_good=np.zeros(4, bool),
            pyr_data=np.full((4, 16, 16, 3), k, np.float32),
            pyr_shapes=np.array([[16, 16]] * 4, np.int32)), np.eye(1, 7, 0, np.float32)[0])
    path = str(tmp_path / "map.npz")
    tckpt.save(path, m)
    m2, _ = tckpt.load(path, cfg, device="cpu")
    assert m2.pyr_device == torch.device("cpu")
    assert all(kf.pyr_data is not None for kf in m2.keyframes)
    assert [kf.pyr_dev is not None for kf in m2.keyframes] == [False] * 3 + [True] * 9
    for kf in m2.keyframes:
        dev = m2.kf_pyr_dev(kf)
        assert dev.device == torch.device("cpu") and float(dev[0, 0, 0, 0]) == kf.kid


def test_jax_checkpoint_resumes_in_port(sequence, tmp_path, caplog):
    frames, gt = sequence
    js = JaxSLAM(_cfg(jcfg))
    for i in range(HALF):
        js.track_monocular(frames[i], float(i))
    assert js.tracker.state == 1
    path = str(tmp_path / "jax.npz")
    js.save_checkpoint(path, extra={"frame_index": HALF - 1})
    for i in range(HALF, len(frames)):
        js.track_monocular(frames[i], float(i))

    slam = TextSLAM(_cfg(tcfg), device="cpu")
    with caplog.at_level(logging.WARNING, logger="textslam_tpu_torch.mapper.checkpoint"):
        extra = slam.load_checkpoint(path)
    assert "lc_gen_state" in caplog.text and "restarts from seed 2" in caplog.text
    assert extra["frame_index"] == HALF - 1 and slam.frame_count == HALF
    jt = JaxSLAM(_cfg(jcfg)).tracker
    jm = jckpt.load(path, _cfg(jcfg), tracker=jt)
    assert_same_state(slam.map, jm, slam.tracker, jt)

    for i in range(HALF, len(frames)):
        slam.track_monocular(frames[i], float(i))
    assert slam.tracker.state == 1
    ate = _kf_ate(slam.map, gt)
    jate = _kf_ate(js.map, gt)
    assert ate < ATE_CLI and abs(ate - jate) < ATE_DIFF, (
        f"port resumed from the JAX checkpoint: KF ATE {ate}, the JAX package's own run {jate}")
    jkf = {kf.timestamp: js.map.kf_pose[kf.kid] for kf in js.map.keyframes}
    common = [kf for kf in slam.map.keyframes if kf.timestamp in jkf]
    assert len(common) >= len(slam.map.keyframes) - 1
    for kf in common:
        R = se3_np.qto_matrix(slam.map.kf_pose[kf.kid][:4]).astype(np.float64)
        Rj = se3_np.qto_matrix(jkf[kf.timestamp][:4]).astype(np.float64)
        deg = np.degrees(np.arccos(np.clip((np.trace(R.T @ Rj) - 1) / 2, -1, 1)))
        assert deg < ROT_DEG, f"keyframe at t={kf.timestamp}: rotation {deg:.3f} deg off JAX"


def test_port_checkpoint_loads_in_jax(port_run):
    path, _ = port_run
    tm, extra = tckpt.load(path, _cfg(tcfg), device="cpu")
    jt = JaxSLAM(_cfg(jcfg)).tracker
    jm = jckpt.load(path, _cfg(jcfg), tracker=jt)
    assert jckpt.read_extra(path) == extra and extra["frame_index"] == HALF - 1
    tt = TextSLAM(_cfg(tcfg), device="cpu").tracker
    tckpt.load(path, _cfg(tcfg), tracker=tt, device="cpu")
    assert_same_state(tm, jm, tt, jt)


def _card_map():
    with gzip.open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "loop_card_map.pkl.gz"), "rb") as f:
        state = pickle.load(f)["map"]
    cfg = dataclasses.replace(tcfg.TextSLAMConfig(), camera=tcfg.CameraConfig(
        fx=torch_synth.FX, fy=torch_synth.FY, cx=torch_synth.CX, cy=torch_synth.CY, fps=6.0))
    rng = np.random.default_rng(0)
    # small stand-in pyramids: the checkpoint stores them as they are
    kfs = [dict(copy.deepcopy(kf), pyr_data=(p := rng.random((4, 12, 16, 3), np.float32)),
                pyr_dev=p, pyr_shapes=np.array([[12, 16], [6, 8], [3, 4], [2, 2]], np.int32))
           for kf in state["keyframes"]]
    return tstate.slam_map_from_numpy(dict(state, keyframes=kfs), cfg, device="cpu"), cfg


def test_text_map_with_pyramids_round_trips(tmp_path):
    tm, cfg = _card_map()
    assert tm.n_texts >= 6 and len(tm.keyframes) >= 9
    tf = TextSLAM(cfg, device="cpu").tracker.text_frontend
    tf.tx_box_uv[:] = np.random.default_rng(1).random(tf.tx_box_uv.shape)
    tf._gen.manual_seed(7)
    torch.rand(3, generator=tf._gen)  # a stream position past the seed
    path = str(tmp_path / "port.npz")
    tckpt.save(path, tm, text_frontend=tf)
    # port -> JAX
    jcfg_ = dataclasses.replace(jcfg.TextSLAMConfig(), camera=jcfg.CameraConfig(
        fx=torch_synth.FX, fy=torch_synth.FY, cx=torch_synth.CX, cy=torch_synth.CY, fps=6.0))
    jslam = JaxSLAM(jcfg_)
    jm = jckpt.load(path, jcfg_, tracker=jslam.tracker, text_frontend=jslam.tracker.text_frontend)
    assert_same_state(tm, jm)
    np.testing.assert_array_equal(jslam.tracker.text_frontend.tx_box_uv, tf.tx_box_uv)
    # JAX -> port, and port -> port with the generator's stream continued
    jpath = str(tmp_path / "jax.npz")
    jckpt.save(jpath, jm)
    for p in (jpath, path):
        slam = TextSLAM(cfg, device="cpu")
        m, _ = tckpt.load(p, cfg, text_frontend=slam.tracker.text_frontend, device="cpu")
        assert_same_state(tm, m)
        keep = cfg.solver.ba_window + 8
        assert [kf.pyr_dev is not None for kf in m.keyframes] == \
            [i >= len(m.keyframes) - keep for i in range(len(m.keyframes))]
        for kf in m.keyframes[-keep:]:
            np.testing.assert_array_equal(kf.pyr_dev.numpy(), kf.pyr_data)
    tf2 = slam.tracker.text_frontend
    np.testing.assert_array_equal(tf2.tx_box_uv, tf.tx_box_uv)
    assert tf2._pool_version == 1 and tf2.map is m
    # the restored generator continues the saved stream
    assert torch.equal(torch.rand(3, generator=tf2._gen), torch.rand(3, generator=tf._gen))


# --------------------------------------------------------------------------
# a text-on resume, field by field: tests/torch_synth.system_state holds every
# field of the map, tracker, text frontend and loop closer; the fields a
# checkpoint deliberately does not restore are torch_synth.RESUME_NOT_RESTORED,
# each with its reason
TEXT_FRAMES, TEXT_SAVE = 10, 7


def _text_cfg(mod):
    return mod.TextSLAMConfig(
        camera=mod.CameraConfig(fx=210.0, fy=210.0, cx=160.0, cy=120.0, width=320, height=240,
                                fps=10.0),
        orb=mod.ORBConfig(n_features=500, n_features_init=1500))


@pytest.fixture(scope="module")
def text_resume(tmp_path_factory):
    """The port with text on over TEXT_FRAMES frames of the text world at
    320x240, saved after TEXT_SAVE frames and loaded into a fresh TextSLAM
    that takes the same later frames: (checkpoint path, the live system's
    state after the load and after each later frame, the resumed system's
    likewise, the live system's text frontend at the save)."""
    K = torch_synth.K.copy()
    K[:2] /= 2
    frames, dets, _, _ = torch_synth.render_text_sequence(TEXT_FRAMES, K_mat=K, size=(320, 240))
    live = TextSLAM(_text_cfg(tcfg), device="cpu")
    path = str(tmp_path_factory.mktemp("ckpt_text") / "text.npz")
    for i in range(TEXT_SAVE):
        live.track_monocular(frames[i], float(i), detections=dets[i])
    saved = {"klt": live.tracker.text_frontend._klt is not None,
             "rows": live.tracker.text_frontend.last_text_rows}
    live.save_checkpoint(path)
    resumed = TextSLAM(_text_cfg(tcfg), device="cpu")
    resumed.load_checkpoint(path)
    states = [(torch_synth.system_state(live), torch_synth.system_state(resumed))]
    for i in range(TEXT_SAVE, TEXT_FRAMES):
        for s in (live, resumed):
            s.track_monocular(frames[i], float(i), detections=dets[i])
        states.append((torch_synth.system_state(live), torch_synth.system_state(resumed)))
    return path, states, saved


def test_text_resume_restores_every_field(text_resume):
    """Right after the load, every field but the listed ones equals the live
    system's: the JAX checkpoint's fields, and the three the port saves
    beyond them (the text-row count that picks the next pose gate, the
    maturation cursor, the KLT accumulator of new boxes), which the parent
    tree lost (its resumed run then took another pose at the next frame and
    other text objects at the next keyframe)."""
    _, states, saved = text_resume
    assert saved["klt"] and saved["rows"] > 0, "the save point must exercise the KLT and row count"
    live, resumed = states[0]
    assert torch_synth.resume_diff(live, resumed) == {}
    # what a load leaves out is in the list: the pool cache at least
    assert "tracker.text_frontend._pool_version" in torch_synth.state_diff(live, resumed)


def test_text_resume_repeats_the_uninterrupted_run(text_resume):
    """The resumed system takes every later frame exactly as the live one
    does: all fields equal after each frame, keyframe insertions included."""
    _, states, _ = text_resume
    for i, (live, resumed) in enumerate(states[1:], TEXT_SAVE):
        assert torch_synth.resume_diff(live, resumed) == {}, f"frame {i}"
    assert live["map.keyframes.len"] > states[0][0]["map.keyframes.len"], \
        "a keyframe after the save"


def test_text_checkpoint_loads_in_jax(text_resume):
    """The port's extra keys (tf_last_text_rows, tf_imm_rr, tf_klt_*) do not
    stop the JAX package's load."""
    path, states, _ = text_resume
    jm = jckpt.load(path, _text_cfg(jcfg))
    assert len(jm.keyframes) == states[0][0]["map.keyframes.len"]
    np.testing.assert_array_equal(jm.kf_pose, states[0][0]["map.kf_pose"])
