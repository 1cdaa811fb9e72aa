"""The scene-only slice end to end: the port's TextSLAM against the JAX
package's on one rendered sequence (12 frames of the lateral path, 320x240
with K halved, 500 / 1500 ORB features; default map pools).

Two comparisons:
- From identical state. The JAX system runs until it initializes; its map
  (slam_map_from_numpy) and tracker state go into the port, and from then
  on both trackers are fed the same keypoints (the JAX frames' host
  mirrors), so ORB's summation-order differences stay out. The first track
  step from the handed-over state must agree to 1e-4 in pose and exactly in
  its matches and inliers. After that, every keyframe insertion runs the
  windowed BA, whose scale direction is held only by LM damping: the cost is
  flat along it to float32 noise (seen: 248.0853 vs 248.0854), so the two
  LM paths legitimately settle at different scales (seen: up to 3%). Per
  frame, rotations must agree to 1e-4, translation directions to 0.2 deg,
  translation norms to 5%; keyframe, point and culled-point counts exactly.
- From scratch. The port runs alone through `track_monocular`. Two-view
  initialization draws other RANSAC sets than JAX and does not share its
  homography-sign defect (tests/test_torch_twoview.py), so the two systems
  may initialize on different frames: both must initialize within the
  first four frames and end within one keyframe of each other, and the port
  must hold ATE against ground truth (keyframes < 0.03, frames < 0.06; the
  JAX package's own run on this sequence reaches 0.022 / 0.059).
"""

import dataclasses

import numpy as np
import pytest
import torch

from textslam_tpu import config as jcfg
from textslam_tpu.frontend.frame import build_frame as jbuild_frame
from textslam_tpu.frontend.frame import ensure_host_kp as jensure_host_kp
from textslam_tpu.system import TextSLAM as JaxSLAM
from textslam_tpu_torch import config as tcfg
from textslam_tpu_torch.frontend.frame import Frame
from textslam_tpu_torch.io.trajectory import read_tum
from textslam_tpu_torch.mapper.state import slam_map_from_numpy
from textslam_tpu_torch.system import TextSLAM

import torch_synth

torch.set_num_threads(2)

N_FRAMES = 12


def _cfg(mod):
    return mod.TextSLAMConfig(
        no_text=True,
        camera=mod.CameraConfig(fx=210.0, fy=210.0, cx=160.0, cy=120.0,
                                width=320, height=240, fps=10.0),
        orb=mod.ORBConfig(n_features=500, n_features_init=1500),
    )


@pytest.fixture(scope="module")
def sequence():
    K = torch_synth.K.copy()
    K[:2] /= 2
    return torch_synth.render_sequence(N_FRAMES, K_mat=K, size=(320, 240))


def _ate(ts, poses, gt):
    return torch_synth.ate_rmse(np.asarray(ts), np.stack(poses), gt)


@pytest.fixture(scope="module")
def lockstep(sequence):
    """Run JAX to initialization, hand its state to the port, then step both
    trackers on identical keypoints. Returns per-frame records."""
    frames, _ = sequence
    js = JaxSLAM(_cfg(jcfg))
    tslam = TextSLAM(_cfg(tcfg), device="cpu")
    jt, tt = js.tracker, tslam.tracker

    def jax_frame(i):
        n = js.cfg.orb.n_features if jt.state == 1 else js.cfg.orb.n_features_init
        f = jbuild_frame(js.cfg, frames[i], i, float(i), n_features=n, with_pyramid=False)
        jensure_host_kp(f)
        return f

    i = 0
    while jt.state != 1 and i < 4:
        jt.process(jax_frame(i))
        i += 1
    init_frame = i - 1
    tslam.map = tt.map = slam_map_from_numpy(vars(js.map), tslam.cfg, device="cpu")
    for k in ("state", "velocity", "last_pose", "prev_pose", "last_kf_frame_id",
              "n_tracked_last_kf"):
        v = getattr(jt, k)
        setattr(tt, k, v.copy() if isinstance(v, np.ndarray) else v)

    def port_frame(jf):
        return Frame(frame_id=jf.frame_id, timestamp=jf.timestamp, shape=jf.shape,
                     kp_uv=jf.kp_uv, kp_level=jf.kp_level, kp_angle=jf.kp_angle,
                     kp_desc=jf.kp_desc, kp_valid=jf.kp_valid)

    # one track step from the identical state, before either tracker moves
    jf = jax_frame(i)
    guess = jt.last_pose.copy()
    first_step = (jt._fused_track(jf, guess), tt._fused_track(port_frame(jf), guess))
    records = []
    for j in range(i, N_FRAMES):
        jf = jax_frame(j)
        tf = port_frame(jf)
        n_kf = len(js.map.keyframes)
        records.append(dict(
            frame=j, ok=(jt.process(jf), tt.process(tf)),
            pose=(jf.pose.copy(), tf.pose.copy()),
            kf_inserted=len(js.map.keyframes) > n_kf,
            n_kf=(len(js.map.keyframes), len(tslam.map.keyframes)),
            n_points=(js.map.n_points, tslam.map.n_points),
            n_bad=(int(js.map.pt_bad.sum()), int(tslam.map.pt_bad.sum())),
        ))
    return init_frame, first_step, records, js, tslam


def test_state_handover_is_exact(lockstep):
    _, _, _, js, tslam = lockstep
    assert len(tslam.map.keyframes) >= 2 and tslam.map.n_points > 100
    # the JAX map only grew after the hand-over; the first KFs' features match
    for kj, kt in zip(js.map.keyframes[:2], tslam.map.keyframes[:2]):
        np.testing.assert_array_equal(kt.kp_desc, kj.kp_desc)
        np.testing.assert_array_equal(kt.kp_uv, kj.kp_uv)


def test_first_track_step_matches(lockstep):
    _, (j, t), _, _, _ = lockstep
    pose_j, idx_j, ok_j, inl_j, n1_j = j
    pose_t, idx_t, ok_t, inl_t, n1_t = t
    np.testing.assert_allclose(pose_t, pose_j, atol=1e-4)
    assert n1_t == n1_j > 20
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_array_equal(inl_t, inl_j)
    np.testing.assert_array_equal(idx_t[ok_t], idx_j[ok_j])


def _angle_deg(a, b):
    c = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


def test_lockstep_poses_and_counts(lockstep):
    init_frame, _, records, _, _ = lockstep
    assert init_frame <= 3
    assert len(records) >= 6
    assert any(r["kf_inserted"] for r in records)  # the windowed BA ran
    for r in records:
        assert r["ok"] == (True, True), r
        assert r["n_kf"][0] == r["n_kf"][1], r
        assert r["n_points"][0] == r["n_points"][1], r
        assert r["n_bad"][0] == r["n_bad"][1], r
        pj, pt = r["pose"]
        np.testing.assert_allclose(pt[:4], pj[:4], atol=1e-4, err_msg=str(r["frame"]))
        assert _angle_deg(pt[4:], pj[4:]) < 0.2, r
        assert abs(np.linalg.norm(pt[4:]) / np.linalg.norm(pj[4:]) - 1.0) < 0.05, r


def test_port_from_scratch(sequence, lockstep, tmp_path):
    frames, gt = sequence
    _, _, _, js, _ = lockstep
    slam = TextSLAM(_cfg(tcfg), output_dir=str(tmp_path), device="cpu")
    init_frame = None
    for i, img in enumerate(frames):
        pose = slam.track_monocular(img, float(i))
        if pose is not None and init_frame is None:
            init_frame = i
    assert init_frame is not None and init_frame <= 3
    assert slam.tracker.state == 1
    assert len(slam.tracker.trajectory) >= N_FRAMES - 4
    assert len(slam.map.keyframes) >= 3 and slam.map.n_points > 100
    assert abs(len(slam.map.keyframes) - len(js.map.keyframes)) <= 1

    kfs = slam.map.keyframes
    kf_ate = _ate([kf.timestamp for kf in kfs], [slam.map.kf_pose[kf.kid] for kf in kfs], gt)
    traj = slam.tracker.trajectory
    frame_ate = _ate([t for t, _ in traj], [p for _, p in traj], gt)
    assert kf_ate < 0.03, kf_ate
    assert frame_ate < 0.06, frame_ate

    # TUM output: the per-KF file the system rewrites, and the final writers
    ts_latest, _ = read_tum(str(tmp_path / "keyframe_latest.txt"))
    assert len(ts_latest) == len(kfs)
    slam.record_frames(str(tmp_path / "frames.txt"))
    ts_frames, poses_wc = read_tum(str(tmp_path / "frames.txt"))
    assert len(ts_frames) == len(traj) and np.isfinite(poses_wc).all()


def test_unported_options_raise(tmp_path):
    """Every option is ported now: checkpointing (a fresh system's
    checkpoint loads back, tests/test_torch_checkpoint.py holds the rest)
    and the multi-device options, which put the BA and the covisibility
    rebuilds on a CPU mesh of that many shards (tests/test_torch_parallel.py
    and tests/test_torch_e2e_mesh.py hold the rest)."""
    slam = TextSLAM(_cfg(tcfg), device="cpu")
    path = str(tmp_path / "fresh.npz")
    slam.save_checkpoint(path, extra={"frame_index": -1})
    assert TextSLAM(_cfg(tcfg), device="cpu").load_checkpoint(path)["frame_index"] == -1
    assert slam.tracker.mesh is None and slam.map._covis_mesh is None
    par = tcfg.ParallelConfig(ba_devices=2)
    slam = TextSLAM(dataclasses.replace(_cfg(tcfg), parallel=par), device="cpu")
    assert slam.tracker.mesh.size == 2 and slam.map._covis_mesh is None
    par = tcfg.ParallelConfig(covis_devices=2)
    slam = TextSLAM(dataclasses.replace(_cfg(tcfg), parallel=par), device="cpu")
    assert slam.tracker.mesh is None and slam.map._covis_mesh.size == 2


def test_cuda_device_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal cannot be shown here")
    with pytest.raises(RuntimeError, match="GPU"):
        TextSLAM(_cfg(tcfg), device="cuda")
    with pytest.raises(RuntimeError, match="GPU"):
        TextSLAM(_cfg(tcfg))  # the default device is the GPU


def test_covisibility_and_culling_match(lockstep):
    """The map bookkeeping after the lockstep run: incremental covisibility,
    culled points and observation counts equal JAX's, and so does a full
    rebuild of M1 from the observation incidence (numpy product in the
    port, the native / numpy product in JAX)."""
    _, _, _, js, tslam = lockstep
    jm, tm = js.map, tslam.map
    np.testing.assert_array_equal(tm.M1, jm.M1)
    np.testing.assert_array_equal(tm.pt_bad, jm.pt_bad)
    np.testing.assert_array_equal(tm.pt_n_obs, jm.pt_n_obs)
    jm.rebuild_covis_m1()
    tm.rebuild_covis_m1()
    np.testing.assert_array_equal(tm.M1, jm.M1)
    np.testing.assert_array_equal(tm.pt_n_obs, jm.pt_n_obs)
