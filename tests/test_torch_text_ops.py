"""The text slice's plain-PyTorch ops held against the JAX package at small
sizes: interp, the x2 pyramid, plane geometry, quad rasterization, ZNCC,
pyramidal KLT and box-ORB. Inputs come from numpy seeds.

Tolerances and why:
- bilinear samples and pyramid levels: 1e-4 absolute on images in
  [0, 255] (float32 lerps and 5-tap sums in the same order; XLA may fuse
  multiply-adds);
- Sobel gradients: 1e-3 absolute (sums of up to 8 terms of +-255);
- plane solves: rtol 1e-4 (3x3 LU in float32 on well-conditioned systems);
- box statistics: rtol 1e-5 (sums over a few hundred pixels in another
  order); masks, labels and keypoint selections exactly;
- KLT: 1e-3 px (ten Gauss-Newton steps; the 2x2 solve is closed form in
  the port and an LU in JAX);
- box-ORB: keypoints, levels and descriptors exactly, angles 1e-4
  (the port's scene ORB is already held to this in test_torch_orb.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from textslam_tpu.geometry import plane as jplane
from textslam_tpu.ops import interp as jinterp
from textslam_tpu.ops import klt as jklt
from textslam_tpu.ops import orb as jorb
from textslam_tpu.ops import pyramid as jpyr
from textslam_tpu.ops import rasterize as jras
from textslam_tpu.ops import zncc as jzncc
from textslam_tpu_torch.geometry import plane as tplane
from textslam_tpu_torch.ops import interp as tinterp
from textslam_tpu_torch.ops import klt as tklt
from textslam_tpu_torch.ops import orb as torb
from textslam_tpu_torch.ops import pyramid as tpyr
from textslam_tpu_torch.ops import rasterize as tras
from textslam_tpu_torch.ops import zncc as tzncc

import torch_synth

torch.set_num_threads(2)

T = torch.from_numpy
J = jnp.asarray


def _img(rng, H=48, W=64):
    return rng.uniform(0, 255, (H, W)).astype(np.float32)


def test_bilinear_family():
    rng = np.random.default_rng(0)
    img = _img(rng)
    img3 = rng.uniform(0, 255, (48, 64, 3)).astype(np.float32)
    uv = np.stack([rng.uniform(-3, 66, 200), rng.uniform(-3, 50, 200)], -1).astype(np.float32)
    uv[0] = [63.0, 47.0]  # the last pixel
    for im in (img, img3):
        jv, jm = jinterp.bilinear(J(im), J(uv))
        tv, tm = tinterp.bilinear(T(im), T(uv))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
    jv, jm = jinterp.bilinear(J(img), J(uv), valid_shape=(40, 50))
    tv, tm = tinterp.bilinear(T(img), T(uv), valid_shape=(40, 50))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
    stack = rng.uniform(0, 255, (3, 48, 64, 3)).astype(np.float32)
    k = rng.integers(0, 3, 200)
    jv, jm = jinterp.bilinear_stack(J(stack), J(k), J(uv))
    tv, tm = tinterp.bilinear_stack(T(stack), T(k), T(uv))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
    # per-feature 8x8 patches around clustered samples
    ctr = np.stack([rng.uniform(0, 64, 20), rng.uniform(0, 48, 20)], -1).astype(np.float32)
    offs = rng.uniform(-2.5, 2.5, (20, 8, 2)).astype(np.float32)
    puv = ctr[:, None] + offs
    kk = rng.integers(0, 3, 20)
    jv, jm = jinterp.patch_bilinear_stack(J(stack), J(kk), J(ctr), J(puv))
    tv, tm = tinterp.patch_bilinear_stack(T(stack), T(kk), T(ctr), T(puv))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)


def test_pyramid():
    rng = np.random.default_rng(1)
    img = _img(rng, 60, 80)
    ji, jg = jpyr.build_pyramid(J(img), levels=4)
    ti, tg = tpyr.build_pyramid(T(img), levels=4)
    for a, b in zip(ti, ji):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3)
    jp = jpyr.pack_pyramid(ji, jg)
    tp = tpyr.pack_pyramid(ti, tg)
    np.testing.assert_array_equal(tp["shapes"], jp["shapes"])
    np.testing.assert_allclose(tp["data"].numpy(), np.asarray(jp["data"]), atol=1e-3)
    uv = np.stack([rng.uniform(0, 40, 30), rng.uniform(0, 30, 30)], -1).astype(np.float32)
    got = tinterp.bilinear_packed(tp["data"], tp["shapes"], 1, T(uv))
    want = jinterp.bilinear_packed(jp["data"], J(jp["shapes"]), 1, J(uv))
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a.numpy(), np.float32), np.asarray(b, np.float32),
                                   atol=1e-3)


def test_plane_geometry():
    rng = np.random.default_rng(2)
    rays = np.concatenate([rng.uniform(-0.5, 0.5, (6, 3, 2)), np.ones((6, 3, 1))], -1).astype(np.float32)
    theta = np.array([0.05, -0.1, -0.3], np.float32)
    rhos = -(rays * theta).sum(-1)
    np.testing.assert_allclose(tplane.solve_theta_3pt(T(rays), T(rhos)).numpy(),
                               np.asarray(jplane.solve_theta_3pt(J(rays), J(rhos))), rtol=1e-4)
    r2 = rays.reshape(-1, 3)
    rh = -(r2 * theta).sum(-1) * rng.uniform(0.98, 1.02, 18).astype(np.float32)
    w = (rng.uniform(size=18) > 0.2).astype(np.float32)
    np.testing.assert_allclose(tplane.fit_theta_lstsq(T(r2), T(rh), T(w)).numpy(),
                               np.asarray(jplane.fit_theta_lstsq(J(r2), J(rh), J(w))), rtol=1e-4)
    T_cr = np.array([0.99, 0.05, -0.1, 0.02, 0.1, -0.05, 0.2], np.float32)
    T_cr[:4] /= np.linalg.norm(T_cr[:4])
    np.testing.assert_allclose(tplane.project_to_target(T(r2), T(theta), T(T_cr)).numpy(),
                               np.asarray(jplane.project_to_target(J(r2), J(theta), J(T_cr))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tplane.transform_theta(T(theta), T(T_cr)).numpy(),
                               np.asarray(jplane.transform_theta(J(theta), J(T_cr))), rtol=1e-5)
    cam = np.array([0.3, -0.1, 0.5], np.float32)
    pts = rng.uniform(-1, 1, (5, 3)).astype(np.float32) + [0, 0, 4]
    np.testing.assert_allclose(
        tplane.view_cos(T(theta), T(T_cr), T(cam), T(pts.astype(np.float32))).numpy(),
        np.asarray(jplane.view_cos(J(theta), J(T_cr), J(cam), J(pts))), rtol=1e-5)
    # a singular 3-point system does not raise: it gives non-finite values
    sing = np.tile(rays[:1, :1], (1, 3, 1))
    assert not torch.isfinite(tplane.solve_theta_3pt(T(sing), T(rhos[:1]))).all()


def test_rasterize():
    rng = np.random.default_rng(3)
    img = _img(rng)
    quads = np.array([[[10, 8], [40, 12], [38, 30], [12, 28]],
                      [[50, 5], [63, 5], [63, 20], [50, 20]],
                      [[-5, 30], [20, 30], [20, 60], [-5, 60]]], np.float32)
    np.testing.assert_array_equal(tras.quad_mask(T(quads), 48, 64).numpy(),
                                  np.asarray(jras.quad_mask(J(quads), 48, 64)))
    for q in quads:
        jm, js, jn = jras.quad_stats(J(img), J(q))
        tm, ts, tn = tras.quad_stats(T(img), T(q))
        assert int(tn) == int(jn)
        np.testing.assert_allclose([float(tm), float(ts)], [float(jm), float(js)], rtol=1e-5)
        jm, js, jn = jras.quad_stats(J(img), J(q), valid_shape=(40, 50))
        tm, ts, tn = tras.quad_stats(T(img), T(q), valid_shape=(40, 50))
        assert int(tn) == int(jn)
        np.testing.assert_allclose([float(tm), float(ts)], [float(jm), float(js)], rtol=1e-5)
    # the batched form the port uses in place of jax.vmap
    tm, ts, tn = tras.quad_stats(T(np.stack([img, img[::-1].copy(), img])), T(quads))
    for i, q in enumerate(quads):
        jm, js, jn = jras.quad_stats(J([img, img[::-1], img][i]), J(q))
        np.testing.assert_allclose([float(tm[i]), float(ts[i])], [float(jm), float(js)], rtol=1e-5)
    pts = np.array([[20, 20], [55, 10], [0, 0], [5, 40]], np.float32)
    valid = np.array([True, True, False])
    np.testing.assert_array_equal(tras.label_lookup(T(quads), T(valid), T(pts)).numpy(),
                                  np.asarray(jras.label_lookup(J(quads), J(valid), J(pts))))
    np.testing.assert_array_equal(tras.point_in_quad(T(pts), T(quads[0])).numpy(),
                                  np.asarray(jras.point_in_quad(J(pts), J(quads[0]))))


def test_zncc():
    rng = np.random.default_rng(4)
    img = _img(rng)
    uv = np.stack([rng.uniform(-2, 66, (3, 50)), rng.uniform(-2, 50, (3, 50))], -1).astype(np.float32)
    ref = rng.uniform(0, 255, (3, 50)).astype(np.float32)
    ref[1] = np.asarray(jinterp.bilinear(J(img), J(uv[1]))[0]) * 0.5 + 20  # correlated
    valid = rng.uniform(size=(3, 50)) > 0.1
    js, jn = jzncc.zncc_gate(J(ref), J(valid), J(img), J(uv))
    ts, tn = tzncc.zncc_gate(T(ref), T(valid), T(img), T(uv))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    assert float(ts[1]) > 0.99


def test_klt_tracks_a_shift():
    frames, _ = torch_synth.render_sequence(2, K_mat=np.diag([105.0, 105.0, 1.0]) + np.array(
        [[0, 0, 80], [0, 0, 60], [0, 0, 0]]), size=(160, 120))
    ji, jg = jpyr.build_pyramid(J(frames[0]), levels=4)
    jj, _ = jpyr.build_pyramid(J(frames[1]), levels=4)
    ti, tg = tpyr.build_pyramid(T(frames[0]), levels=4)
    tj, _ = tpyr.build_pyramid(T(frames[1]), levels=4)
    rng = np.random.default_rng(5)
    uv = np.stack([rng.uniform(20, 140, 40), rng.uniform(20, 100, 40)], -1).astype(np.float32)
    valid = np.ones(40, bool)
    valid[3] = False
    juv, jok = jklt.klt_track(ji, jg, jj, J(uv), J(valid))
    tuv, tok = tklt.klt_track(ti, tg, tj, T(uv), T(valid))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    ok = tok.numpy()
    assert ok.sum() >= 15
    np.testing.assert_allclose(tuv.numpy()[ok], np.asarray(juv)[ok], atol=1e-3)


def test_extract_box_orb():
    frames, _ = torch_synth.render_sequence(1, K_mat=np.diag([210.0, 210.0, 1.0]) + np.array(
        [[0, 0, 160], [0, 0, 120], [0, 0, 0]]), size=(320, 240))
    img = frames[0]
    quads = np.zeros((4, 4, 2), np.float32)
    quads[0] = [[40, 50], [160, 55], [158, 110], [42, 105]]
    quads[1] = [[200, 140], [300, 140], [300, 200], [200, 200]]
    valid = np.array([True, True, False, False])
    jk = jorb.extract_box_orb(J(img), J(quads), J(valid), n_keep=64, threshold=7.0, shrink=3.0)
    tk = torb.extract_box_orb(T(img), T(quads), T(valid), n_keep=64, threshold=7.0, shrink=3.0)
    np.testing.assert_array_equal(tk.valid.numpy(), np.asarray(jk.valid))
    assert int(tk.valid.sum()) > 20
    np.testing.assert_array_equal(tk.uv.numpy(), np.asarray(jk.uv))
    np.testing.assert_array_equal(tk.desc.numpy().view(np.uint32), np.asarray(jk.desc))
    np.testing.assert_allclose(tk.angle.numpy(), np.asarray(jk.angle), atol=1e-4)
