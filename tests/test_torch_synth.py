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


# the long-run fixtures: outback2, the ring circuit, the degradation

@pytest.mark.parametrize("kind,n", [("outback2", 200), ("outback2", 37), ("ring", 400),
                                    ("ring", 1000)])
def test_long_camera_paths_match(kind, n):
    np.testing.assert_allclose(torch_synth.camera_path(n, kind), synth.camera_path(n, kind),
                               atol=1e-6)


def test_ring_constants_match():
    for name in ("RING_SEGMENTS", "RING_SPACING", "RING_RADIUS", "RING_LAPS"):
        assert getattr(torch_synth, name) == getattr(synth, name), name


@pytest.fixture(scope="module")
def ring_worlds():
    return synth.ring_world(seed=3), torch_synth.ring_world(seed=3)


def test_ring_world_boxes_match(ring_worlds):
    wj, wt = ring_worlds
    assert len(wt.planes) == len(wj.planes) == torch_synth.RING_SEGMENTS
    for pj, pt in zip(wj.planes, wt.planes):
        assert pj[0] == pt[0] and pj[1] == pt[1]
        np.testing.assert_array_equal(pt[4], pj[4])
    assert len(wt.boxes) == len(wj.boxes) >= 24
    for (pj, qj, sj), (pt, qt, st) in zip(wj.boxes, wt.boxes):
        assert (pt, st) == (pj, sj)
        np.testing.assert_array_equal(qt, qj)


@pytest.mark.parametrize("frame", [0, 170, 399])
def test_ring_world_render_and_detections(ring_worlds, frame):
    """The same tolerances as the text world's: 0.05 gray on every pixel,
    detections in the same order with corners to 1e-3 px."""
    wj, wt = ring_worlds
    pose = synth.camera_path(400, "ring")[frame]
    np.testing.assert_allclose(wt.render(pose), wj.render(pose), atol=0.05)
    dj, dt = wj.detections(pose), wt.detections(pose)
    assert len(dt) == len(dj) >= 1
    for a, b in zip(dt, dj):
        assert (a.text, a.score, a.lang) == (b.text, b.score, b.lang)
        np.testing.assert_allclose(a.quad, b.quad, atol=1e-3)


def test_degrade_schedule_exact():
    for n in (1, 50, 200, 1000):
        np.testing.assert_array_equal(torch_synth.degrade_schedule(n), synth.degrade_schedule(n))
    np.testing.assert_array_equal(torch_synth.degrade_schedule(300, 0.1, 0.5, 0.1),
                                  synth.degrade_schedule(300, 0.1, 0.5, 0.1))


@pytest.mark.parametrize("g", [0.0, 0.02, 0.1, 0.45, 1.0])
def test_degrade_frame_matches_cv2(g):
    """The blur in numpy against cv2.GaussianBlur (kernel sizes 1 to 9):
    mean absolute error < 0.5 gray on the same image and noise draws."""
    img = torch_synth.TextWorld(seed=3, boxes_per_plane=3).render(synth.camera_path(20)[7])
    a = synth.degrade_frame(img, np.random.default_rng(5), g)
    b = torch_synth.degrade_frame(img, np.random.default_rng(5), g)
    assert b.dtype == np.float32 and b.shape == img.shape
    assert np.abs(a - b).mean() < 0.5


class TestRingWorldGeometry:
    """tests/test_ring_world.py's geometry pins, on the port's fixture."""

    @pytest.fixture(scope="class")
    def ring(self):
        return torch_synth.ring_world(seed=3), torch_synth.camera_path(400, "ring")

    @staticmethod
    def _strings(world, pose):
        return {d.text for d in world.detections(pose)}

    def test_start_walls_leave_view_mid_lap(self, ring):
        world, poses = ring
        start = self._strings(world, poses[0])
        assert len(start) >= 6, start
        mid = set()
        for i in range(140, 210):
            mid |= self._strings(world, poses[i])
        assert start.isdisjoint(mid), start & mid

    def test_revisit_sees_start_walls_again(self, ring):
        world, poses = ring
        assert len(self._strings(world, poses[0]) & self._strings(world, poses[-1])) >= 4

    def test_every_frame_has_texture_and_text(self, ring):
        world, poses = ring
        for i in range(0, 400, 10):
            assert (world.render(poses[i]) > 0).mean() > 0.5, f"frame {i} mostly empty"
            assert world.detections(poses[i]), f"frame {i}: no text"

    def test_no_world_point_spans_both_eras(self, ring):
        from textslam_tpu_torch.geometry import se3_np

        world, poses = ring

        def visible(points_w, pose):
            pc = points_w @ se3_np.qto_matrix(pose[:4]).T + pose[4:]
            z = np.maximum(pc[:, 2], 0.1)
            u = synth.FX * pc[:, 0] / z + synth.CX
            v = synth.FY * pc[:, 1] / z + synth.CY
            return (pc[:, 2] > 0.1) & (u >= 0) & (u < synth.W) & (v >= 0) & (v < synth.H)

        pts = []
        for z0, s, tex, mask, off in world.planes:
            half = tex.shape[0] / (2 * s)
            gx, gy = np.meshgrid(np.linspace(-half, half, 40) + off[0],
                                 np.linspace(-half, half, 40) + off[1])
            pts.append(np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, z0)], -1))
        pts = np.concatenate(pts)
        start = visible(pts, poses[0])
        for i in range(140, 210, 10):
            assert not (start & visible(pts, poses[i])).any(), f"frame {i}"
