"""The cv2-free renderer (tests/torch_synth.py) held against tests/synth.py,
and its distorted render against tests/test_cli_e2e.py's (cv2.undistortPoints
and cv2.remap): undistorted pixels within 1e-4 px, images within the same
0.05 gray.

Tolerance: 0.05 gray out of 255 on every pixel. Both renderers warp the
same float32 textures through the same homographies; they differ only in
how cv2 rounds its float interpolation (~0.02 gray seen) and in the last
bits of the 3x3 texture blur (3e-5). Plane masks must agree exactly, so no
pixel changes plane.
"""

import numpy as np
import pytest

import synth
import torch_synth


@pytest.fixture(scope="module")
def worlds():
    return synth.PlaneWorld(seed=0), torch_synth.PlaneWorld(seed=0)


def test_textures_match(worlds):
    wj, wt = worlds
    for pj, pt in zip(wj.planes, wt.planes):
        assert pj[0] == pt[0] and pj[1] == pt[1]
        np.testing.assert_allclose(pt[2], pj[2], atol=1e-4)
        np.testing.assert_array_equal(pt[3], pj[3])


def test_camera_path_matches():
    np.testing.assert_allclose(torch_synth.camera_path(40), synth.camera_path(40), atol=1e-6)
    np.testing.assert_allclose(torch_synth.camera_path(9, "forward"),
                               synth.camera_path(9, "forward"), atol=1e-6)


@pytest.mark.parametrize("frame", [0, 21, 39])
def test_render_full_size(worlds, frame):
    wj, wt = worlds
    pose = synth.camera_path(40)[frame]
    np.testing.assert_allclose(wt.render(pose), wj.render(pose), atol=0.05)


def test_render_half_size(worlds):
    wj, wt = worlds
    K2 = synth.K.copy()
    K2[:2] /= 2
    pose = synth.camera_path(10)[4]
    np.testing.assert_allclose(wt.render(pose, K_mat=K2, size=(320, 240)),
                               wj.render(pose, K_mat=K2, size=(320, 240)), atol=0.05)


def test_ate_matches_synth():
    gt = synth.camera_path(30)
    rng = np.random.default_rng(0)
    est = gt.copy()
    est[:, 4:] = 1.7 * (est[:, 4:] + rng.normal(0, 0.01, (30, 3)))
    ts = np.arange(0, 30, 2)
    # float64 numpy vs float32 JAX alignment
    np.testing.assert_allclose(torch_synth.ate_rmse(ts, est[ts], gt),
                               synth.ate_rmse(ts, est[ts], gt), rtol=1e-4)


@pytest.fixture(scope="module")
def text_worlds():
    return synth.TextWorld(seed=0), torch_synth.TextWorld(seed=0)


def test_text_world_boxes_match(text_worlds):
    wj, wt = text_worlds
    assert len(wt.boxes) == len(wj.boxes) >= 6
    for (pj, qj, sj), (pt, qt, st) in zip(wj.boxes, wt.boxes):
        assert (pt, st) == (pj, sj)
        np.testing.assert_array_equal(qt, qj)


@pytest.mark.parametrize("frame", [0, 12, 23])
def test_text_detections_match(text_worlds, frame):
    """Detections projected from the ground-truth boxes: the same boxes in
    the same order, corners to 1e-3 px (float64 numpy vs the JAX rotation
    matrix in float32), strings and scores exactly."""
    wj, wt = text_worlds
    pose = synth.camera_path(24)[frame]
    dj, dt = wj.detections(pose), wt.detections(pose)
    assert len(dt) == len(dj) >= 4
    for a, b in zip(dt, dj):
        assert (a.text, a.score, a.lang) == (b.text, b.score, b.lang)
        np.testing.assert_allclose(a.quad, b.quad, atol=1e-3)


def test_plane_theta_matches():
    for pose in synth.camera_path(24)[::7]:
        for z0 in (2.8, 7.0):
            np.testing.assert_allclose(torch_synth.plane_theta_in_cam(z0, pose),
                                       synth.plane_theta_in_cam(z0, pose), rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def cli_e2e():
    import test_cli_e2e

    return test_cli_e2e


def test_undistort_points_matches_cv2(cli_e2e):
    qx, qy = np.meshgrid(np.arange(synth.W, dtype=np.float64), np.arange(synth.H, dtype=np.float64))
    und = torch_synth.undistort_points(np.stack([qx, qy], -1), torch_synth.K, cli_e2e.DIST)
    np.testing.assert_allclose(und, cli_e2e._UND, atol=1e-4)


@pytest.mark.parametrize("frame", [0, 10])
def test_render_distorted_matches_cli_e2e(cli_e2e, frame):
    pose = synth.camera_path(20)[frame]
    rays = torch_synth.distorted_rays(cli_e2e.DIST)
    ours = torch_synth.render_distorted(torch_synth.TextWorld(seed=1), pose, rays)
    np.testing.assert_allclose(ours, cli_e2e.render_distorted(synth.TextWorld(seed=1), pose),
                               atol=0.05)
