"""The plain reference against the program's own plain versions on the CPU,
the ground-truth arithmetic, and that the reference loads nothing of the
program."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from slambench.lib import world
from slambench.reference import ba_plain, groundtruth, hamming_plain, orb_plain, sampler_plain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frame(seed=3):
    """A 320x240 frame of a small walk with its detections."""
    traffic = {"segments": 12, "spacing_m": 1.0, "depths_m": [1.8, 2.6], "px_per_m": 250.0,
               "texture_px": 512, "blobs": 1500, "boxes_per_segment": 3, "box_grid": 3,
               "box_px": [[70, 110], [35, 55]], "layout_seed": 11, "speed_mps": 0.413,
               "mean_angular_speed_dps": 23.327, "sway_deg": [6.0, 4.0, 3.0],
               "sway_hz": [0.31, 0.43, 0.27, 0.19, 0.9, 0.23],
               "sway_phase": [0.0, 1.1, 2.3, 0.7, 0.0, 1.9], "bob_m": [0.04, 0.02, 0.05],
               "detection_margin_px": 8.0, "detection_score": 0.9}
    cam = {"fx": 192.2, "fy": 191.4, "cx": 157.8, "cy": 124.6, "width": 320, "height": 240,
           "fps": 60.0}

    class Det:
        def __init__(self, quad, text, score):
            self.quad, self.text, self.score = quad, text, score

    w = world.Walk(traffic, seed, cam, 120, "cpu", Det)
    return w, w.frame(4)


def test_orb_reference_equals_the_program_build():
    from textslam_tpu_torch.ops import orb

    _, (img, dets) = _frame()
    quads = np.stack([d.quad for d in dets])
    ref = orb_plain.orb(img, 500, 8, 1.2, 7.0, quads=quads, n_box=256, shrink=3.0)
    main = orb.extract_orb(img, n_features=500, n_levels=8, scale=1.2, threshold=7.0)
    box = orb.extract_box_orb(img, torch.as_tensor(quads), torch.ones(len(quads), dtype=torch.bool),
                              n_keep=256, threshold=7.0, shrink=3.0)
    prog = {"uv": torch.cat([main.uv, box.uv]), "level": torch.cat([main.level, box.level]),
            "desc": torch.cat([main.desc, box.desc]), "valid": torch.cat([main.valid, box.valid])}
    mism, comp = orb_plain.keypoint_mismatch(prog, ref)
    assert comp > 300 and mism == 0
    # the lower-precision control moves keypoints
    low = orb_plain.orb(img, 500, 8, 1.2, 7.0, quads=quads, storage=torch.bfloat16)
    assert orb_plain.keypoint_mismatch(low, ref)[0] > comp // 10


def test_hamming_reference_equals_the_program_plain_version():
    from textslam_tpu_torch.ops import matching

    g = torch.Generator().manual_seed(1)
    d1, alt, d2 = (torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 8), dtype=torch.int32, generator=g)
                   for n in (300, 300, 77))
    assert torch.equal(hamming_plain.hamming(d1, d2), matching.hamming_matrix_plain(d1, d2))
    assert torch.equal(hamming_plain.hamming(d1, d2, alt),
                       matching.hamming_matrix_min_plain(d1, alt, d2))


def test_sampler_reference_against_the_program_plain_version():
    from textslam_tpu_torch.ops import patch_sample

    g = torch.Generator().manual_seed(2)
    imgs = torch.rand((3, 240, 320, 3), generator=g) * 255
    gk = torch.tensor([0, 2, 1, 1])
    centre = torch.tensor([[40.0, 30.0], [300.0, 200.0], [150.0, 120.0], [318.5, 10.0]])
    uv = centre[:, None, :] + torch.randn((4, 64, 2), generator=g) * 20
    vals, mask = patch_sample.grouped_bilinear_stack_plain(imgs, gk, uv)
    ref_v, ref_m = sampler_plain.sample(imgs, gk, uv)
    err, mdiff = sampler_plain.sample_error(vals, mask, ref_v, ref_m)
    assert mdiff == 0 and mask.any() and (~mask).any()
    assert err < 1e-5
    low_v, low_m = sampler_plain.sample(imgs, gk, uv, dtype=torch.float32, storage=torch.bfloat16)
    assert sampler_plain.sample_error(low_v, low_m, ref_v, ref_m)[0] > 1e-3


def test_ate_is_zero_for_the_truth_and_invariant_to_a_similarity():
    w, _ = _frame()
    gt = w.poses
    ids = np.arange(len(gt))
    assert groundtruth.ate_rmse(ids, gt, gt) < 1e-6
    # the same trajectory in another world frame: centres C' = 2 G C + c,
    # rotations R_cw' = R_cw G^T
    G = world.rotation(np.array([0.3]), np.array([-0.2]), np.array([0.1]))[0]
    R = groundtruth.qto_matrix(gt[:, :4].astype(np.float64)) @ G.T
    C = 2.0 * groundtruth.camera_centres(gt) @ G.T + np.array([0.3, -0.1, 0.2])
    moved = np.concatenate([world.quaternion(R), -np.einsum("nij,nj->ni", R, C)], -1)
    assert groundtruth.ate_rmse(ids, moved, gt) < 1e-5
    bent = gt.copy()
    bent[60:, 4] += 0.05
    assert groundtruth.ate_rmse(ids, bent, gt) > 0.01


def test_plane_error_of_the_true_plane_is_zero():
    w, _ = _frame()
    wi = 0
    th = groundtruth.plane_theta_in_cam(w.layout["walls"][wi][2], w.poses[3])
    errs = groundtruth.plane_errors([(th, 3, wi), (th + np.array([0.2, 0, 0]), 3, wi)],
                                    w.layout["walls"], w.poses)
    assert errs[0] < 1e-12 and errs[1] > 1e-3


def test_walk_moves_as_its_traffic_states_and_renders_through_its_poses():
    """Mean speed and angular speed as the traffic file states them, a
    rotation on every axis, and each detection where the ground-truth pose
    projects its box's corners."""
    w, _ = _frame()
    C = groundtruth.camera_centres(w.poses)
    R = groundtruth.qto_matrix(w.poses[:, :4].astype(np.float64))  # R_cw
    assert np.linalg.norm(np.diff(C, axis=0), axis=-1).mean() * 60 == pytest.approx(0.413, rel=1e-3)
    dR = np.einsum("nij,nkj->nik", R[1:], R[:-1])
    ang = np.degrees(np.arccos(np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    assert ang.mean() * 60 == pytest.approx(23.327, rel=1e-3)
    tilt = np.degrees(np.arcsin(np.abs(R[:, 2, :2])))  # optical axis off the walls' normal
    assert tilt.max() > 3.0
    i = 90
    _, dets = w.frame(i)
    assert dets
    s, walls = w.layout["px_per_m"], w.layout["walls"]
    half = w.layout["texture_px"] / (2 * s)
    for d in dets:
        wi, (bx, by, bw, bh), _ = next(b for b in w.layout["boxes"] if b[2] == d.text)
        x0, y0, z = walls[wi][0] - half, walls[wi][1] - half, walls[wi][2]
        P = np.array([[x0 + bx / s, y0 + by / s, z]])
        p = P @ R[i].T + w.poses[i, 4:]
        uv = [192.2 * p[0, 0] / p[0, 2] + 157.8, 191.4 * p[0, 1] / p[0, 2] + 124.6]
        assert np.allclose(d.quad[0], uv, atol=1e-3)


def _ba_problem(K=4, P=300, seed=0):
    """A small BA problem: K cameras, P inverse-depth points seen from every
    camera, pixel noise, an outlier in 37, the first camera fixed."""
    from textslam_tpu_torch.solver import ba

    g = torch.Generator().manual_seed(seed)
    ang = torch.randn((K, 3), generator=g) * 0.02
    q = torch.cat([torch.ones(K, 1), ang / 2], 1)
    poses = torch.cat([q / q.norm(dim=1, keepdim=True),
                       torch.stack([-0.1 * torch.arange(K), 0.01 * torch.arange(K),
                                    torch.zeros(K)], 1)], 1)
    host = torch.randint(0, K, (P,), generator=g)
    ray = torch.cat([torch.rand((P, 2), generator=g) * 1.2 - 0.6, torch.ones(P, 1)], 1)
    rho = 1.0 / (1.5 + torch.rand(P, generator=g) * 2)
    tgt, pt = (a.reshape(-1) for a in torch.meshgrid(torch.arange(K), torch.arange(P),
                                                      indexing="ij"))
    d = {"poses": poses, "pose_free": torch.ones(K, dtype=torch.bool), "rho": rho,
         "rho_free": torch.ones(P, dtype=torch.bool), "tgt": tgt, "host": host[pt],
         "host_pose": poses[host[pt]], "host_in_window": torch.ones(len(tgt), dtype=torch.bool),
         "point": pt, "ray": ray[pt], "uv": torch.zeros(len(tgt), 2),
         "weight": torch.full((len(tgt),), 1 / 1.2), "valid": tgt != host[pt],
         "fx": 384.0, "fy": 383.0, "cx": 320.0, "cy": 240.0, "huber": 2.447}
    r, _ = ba_plain.residuals(d, ba_plain._state(d, torch.float64))
    uv = (r / d["weight"][:, None].double() + torch.randn(r.shape, generator=g, dtype=torch.float64)
          * 0.7).float()
    uv[::37] += 15.0
    free = torch.ones(K, dtype=torch.bool)
    free[0] = False
    noisy = poses.clone()
    noisy[1:, 4:] += torch.randn((K - 1, 3), generator=g) * 0.01
    scene = ba.SceneObs(tgt=tgt, host=host[pt], host_frozen_pose=poses[host[pt]],
                        host_in_window=d["host_in_window"], point=pt, ray=ray[pt], uv=uv,
                        weight=d["weight"], valid=d["valid"])
    return ba.BAProblem(poses=noisy, pose_free=free, rho=rho * (1 + 0.05 * torch.randn(
        P, generator=g)), rho_free=torch.ones(P, dtype=torch.bool), scene=scene,
        fx=384.0, fy=383.0, cx=320.0, cy=240.0)


@pytest.mark.parametrize("shape", ["ba", "pose", "points"])
def test_ba_reference_follows_the_program_solver(shape):
    """The plain LM on the solver's schedule reaches the program's solution
    to rounding; the solver's start reads 1 and the bfloat16 control far
    more than rounding."""
    from slambench.lib import check
    from textslam_tpu_torch.solver import ba

    prob = _ba_problem()
    K, P = prob.poses.shape[0], prob.rho.shape[0]
    if shape == "pose":
        prob = prob._replace(pose_free=torch.arange(K) == 2, rho_free=torch.zeros(P, dtype=torch.bool))
    if shape == "points":
        prob = prob._replace(pose_free=torch.zeros(K, dtype=torch.bool))
    out = ba.solve_ba(prob, n_iters=10, huber_scene=2.447)
    d = check.scene_problem(prob, 2.447)
    d = {k: (v.double() if torch.is_tensor(v) and v.is_floating_point() else v) for k, v in d.items()}
    ref = ba_plain.solve(d, n_iters=10)
    g, dec = ba_plain.gap(d, ba_plain.state_of(d, out.poses, out.rho), ref)
    assert dec > 1e-3 and abs(g) < 1e-3
    assert ba_plain.gap(d, ba_plain.state_of(d, prob.poses, prob.rho), ref)[0] == pytest.approx(1.0)
    low = ba_plain.solve(d, n_iters=10, dtype=torch.float32, storage=torch.bfloat16)
    assert ba_plain.gap(d, tuple(a.double() for a in low), ref)[0] > 0.01


def test_walk_strings_are_drawn_from_the_seed():
    w1, (img1, dets1) = _frame(seed=3)
    w2, (img2, dets2) = _frame(seed=3)
    w3, (img3, dets3) = _frame(seed=4)
    assert torch.equal(img1, img2) and [d.text for d in dets1] == [d.text for d in dets2]
    # the same frame in other words for another seed
    assert torch.equal(img1, img3) and [d.text for d in dets1] != [d.text for d in dets3]
    # the same boxes in other words for another seed
    assert [b[:2] for b in w1.layout["boxes"]] == [b[:2] for b in w3.layout["boxes"]]
    assert [b[2] for b in w1.layout["boxes"]] != [b[2] for b in w3.layout["boxes"]]
    assert len({b[2] for b in w1.layout["boxes"]}) == 36  # unique strings
    assert dets1 and all(d.quad.shape == (4, 2) for d in dets1)
    # a large seed, beyond 32 signed bits
    world.ring_layout({"segments": 2, "spacing_m": 1.0, "depths_m": [2.0], "px_per_m": 250.0,
                       "texture_px": 512, "box_grid": 3, "box_px": [[70, 110], [35, 55]],
                       "layout_seed": 11, "boxes_per_segment": 9}, 2 ** 33 + 5)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import slambench.reference.groundtruth, slambench.reference.orb_plain, "
            "slambench.reference.hamming_plain, slambench.reference.sampler_plain, "
            "slambench.reference.ba_plain; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'textslam_tpu', 'textslam_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("names,found", [
    (["textslam_tpu_torch", "textslam_tpu_torch.ops"], []),
    (["jaxlib.xla_client", "numpy"], ["jaxlib"]),
    (["textslam_tpu.ops", "flax", "jax"], ["flax", "jax", "textslam_tpu"]),
    (["jaxtyping", "textslam_tpu_extra"], []),
])
def test_import_check_compares_whole_top_level_names(names, found):
    from slambench import testing

    assert testing.load_run_module().forbidden_modules(names) == found
