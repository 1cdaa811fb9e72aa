"""The loop-closing slice as a whole: the port alone, from scratch, on
tests/test_e2e_loop.py's out-and-back fixture (the rendered text world's
`outback` path, out along +x and back to the start, with ground-truth
detections, the fixture's loop gates and its amnesia hooks: from the middle
of the sequence on, the tracker forgets the landmarks hosted in the first
quarter's keyframes, so the return leg builds a duplicate map that the
closer must find and fuse), at 320x240 with K halved and 500 / 1500 ORB
features as tests/test_torch_text_slam.py runs the text slice,
iters_landmark = 10 as test_e2e_loop. The JAX side of this fixture is
tests/test_e2e_loop.py (at 640x480; on this 320x240 sequence the JAX
package does not initialize, see ROADMAP C, the two-view homography sign).

The path is sampled in 20 frames, not test_e2e_loop's 32. Over 32 frames
at 320x240 the first frame pair, where the port initializes, has ~0.06 m of
baseline against planes 2-7 m away: the two-view pose is ill-conditioned,
and the CPU's float summation order decides it (with 2 torch threads the
keyframe ATE ends at 0.052, with 1 or 4 at 0.017 and 0.015). Over 20
frames runs with 1, 2 and 4 threads close the same loop and end at
keyframe ATE 0.009-0.011 (`PYTHONPATH=. python tests/test_torch_loop_e2e.py
FRAMES THREADS` prints these).

The bars are test_e2e_loop's: a loop closed to an older keyframe, landmarks
fused, finite keyframe poses with keyframe ATE < 0.03 and no worse than
just before the correction, the two legs' covisibility bridged, and the
post-loop re-tracking (the last 3 frames fed again) consuming first-leg
points.
"""

import numpy as np
import pytest
import torch

import torch_synth
from textslam_tpu_torch import config as tcfg
from textslam_tpu_torch.system import TextSLAM

torch.set_num_threads(2)

N_FRAMES = 20


def _ate(m, gt):
    kfs = m.keyframes
    return torch_synth.ate_rmse([kf.timestamp for kf in kfs],
                                np.stack([m.kf_pose[kf.kid] for kf in kfs]), gt)


def loop_run(n_frames: int = N_FRAMES, kf_ate=None):
    """The fixture's run over n_frames: (slam, ground truth, [KF ATE just
    before the correction], [hosts of the points each post-loop frame
    tracked]). kf_ate, when given, is called with the KF ATE after each
    keyframe insertion."""
    K = torch_synth.K.copy()
    K[:2] /= 2
    frames, dets, gt, _ = torch_synth.render_text_sequence(n_frames, kind="outback", K_mat=K,
                                                           size=(320, 240))
    cfg = tcfg.TextSLAMConfig(
        camera=tcfg.CameraConfig(fx=210.0, fy=210.0, cx=160.0, cy=120.0, width=320,
                                 height=240, fps=6.0),
        orb=tcfg.ORBConfig(n_features=500, n_features_init=1500),
        loop=tcfg.LoopConfig(min_kfs_before_loop=6, min_kfs_between_loops=5,
                             num_covis_for_thresh=3),
        solver=tcfg.SolverConfig(iters_landmark=10),
    )
    slam = TextSLAM(cfg, device="cpu")
    tr = slam.tracker
    amnesia = {"cutoff": None}

    def amnesia_hook(pt_valid):
        cut = amnesia["cutoff"]
        if cut is not None:
            m = slam.map
            n = min(m.n_points, len(pt_valid))
            pt_valid[:n] &= ~(m.pt_host[:n] < cut)
        return pt_valid

    def text_amnesia_mask(n_texts):
        mask = np.ones(n_texts, bool)
        if amnesia["cutoff"] is not None:
            mask &= ~(slam.map.tx_host[:n_texts] < amnesia["cutoff"])
        return mask

    tr.pt_candidate_hook = amnesia_hook
    tr.text_frontend.pool_mask_hook = text_amnesia_mask
    pre_ate = []
    correct = slam.loop_closer.correct

    def correct_recording(*a, **k):
        pre_ate.append(_ate(slam.map, gt))
        return correct(*a, **k)

    slam.loop_closer.correct = correct_recording
    cutoff_at_quarter = None
    for i, img in enumerate(frames):
        if i == n_frames // 4:
            cutoff_at_quarter = len(slam.map.keyframes)
        if i == n_frames // 2:
            amnesia["cutoff"] = cutoff_at_quarter
        n_kf = len(slam.map.keyframes)
        slam.track_monocular(img, float(i), detections=dets[i])
        if kf_ate is not None and len(slam.map.keyframes) > max(n_kf, 2):
            kf_ate(_ate(slam.map, gt))
    amnesia["cutoff"] = None

    # post-loop re-tracking: the final frames again, amnesia lifted; record
    # the hosts of the points the per-frame matcher consumes
    post_hosts = []
    if slam.loop_closer.closed_loops:
        chain = tr._chain_frame

        def chain_recording(frame, guess, radius_scale=1.0):
            track, hook, imm = chain(frame, guess, radius_scale)
            m = slam.map
            sel = np.nonzero(track[2])[0]
            post_hosts.append(m.pt_host[sel[sel < m.n_points]].copy())
            return track, hook, imm

        tr._chain_frame = chain_recording
        for i in range(n_frames - 3, n_frames):
            slam.track_monocular(frames[i], float(i), detections=dets[i])
        tr._chain_frame = chain
    return slam, gt, pre_ate, post_hosts


@pytest.fixture(scope="module")
def result():
    return loop_run()


def test_loop_detected_and_closed(result):
    slam, _, _, _ = result
    assert slam.loop_closer.closed_loops, "no loop closed"
    cur, cand = slam.loop_closer.closed_loops[0]
    assert cand < cur
    assert cand in slam.map.keyframes[cur].loop_edges


def test_landmarks_fused(result):
    m = result[0].map
    assert m.pt_bad[: m.n_points].sum() > 0 or (~m.tx_valid[: m.n_texts]).sum() > 0


def test_trajectory_not_degraded(result):
    slam, gt, pre_ate, _ = result
    m = slam.map
    assert np.isfinite(m.kf_pose[: len(m.keyframes)]).all()
    ate = _ate(m, gt)
    assert pre_ate and ate <= pre_ate[0], (ate, pre_ate)


def test_keyframe_ate(result):
    """test_e2e_loop's post-loop trajectory bar."""
    slam, gt, _, _ = result
    ate = _ate(slam.map, gt)
    assert ate < 0.03, ate


def test_covisibility_bridged(result):
    m = result[0].map
    cur, cand = result[0].loop_closer.closed_loops[0]
    K = len(m.keyframes)
    assert m.M1[: cand + 1, cand + 1: K].sum() + m.M2[: cand + 1, cand + 1: K].sum() > 0


def test_post_loop_retracking_consumes_old_landmarks(result):
    slam, _, _, post_hosts = result
    assert post_hosts, "no post-loop frames were tracked"
    cur, cand = slam.loop_closer.closed_loops[0]
    old = np.concatenate(post_hosts)
    assert (old <= cand).sum() > 0, f"no loop-side landmark re-entered tracking: {np.unique(old)}"


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_loop_e2e.py FRAMES THREADS: the run's keyframe
    # ATE after each keyframe insertion, just before the correction and at
    # the end, under that many torch threads
    import sys

    n_frames, threads = int(sys.argv[1]), int(sys.argv[2])
    torch.set_num_threads(threads)
    trace = []
    slam, gt, pre, _ = loop_run(n_frames, trace.append)
    print(f"{n_frames} frames, {threads} torch threads: loops {slam.loop_closer.closed_loops}, "
          f"KF ATE after each KF insertion {[round(a, 4) for a in trace]}, before the "
          f"correction {pre}, at the end {_ate(slam.map, gt):.6f}")
