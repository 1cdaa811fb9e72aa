"""The text frontend's device functions (textslam_tpu_torch/frontend/text.py)
held against the JAX package's, on a rendered text world at 320x240 (K
halved): reference-feature extraction, the per-object packed reference, the
seed features of unmapped boxes, the TextJudge gates, theta RANSAC by
outcome, and the batched IMMATURE theta solve.

Tolerances and why:
- selected pixels, validity flags, masks and gate decisions exactly (the
  same integer selections; ties keep the lower index on both sides);
- reference intensities, box statistics and ZNCC scores 1e-4 relative
  (float32 sums over a few hundred pixels in another order);
- theta RANSAC by outcome: its Gumbel keys come from a torch.Generator, not
  the JAX PRNG, so both must recover the true plane (cos > 0.999) and agree
  on degeneracy;
- the batched theta solve: thetas 1e-3 relative, information matrices 1e-3
  of the largest entry (3 levels x 11 LM builds in float32, sums in another
  order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textslam_tpu.frontend import text as jtext
from textslam_tpu.ops import pyramid as jpyr
from textslam_tpu_torch.frontend import text as ttext

import torch_synth

torch.set_num_threads(2)

FX, FY, CX, CY = 210.0, 210.0, 160.0, 120.0
def T(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def world():
    K = torch_synth.K.copy()
    K[:2] /= 2
    frames, dets, gt, w = torch_synth.render_text_sequence(3, K_mat=K, size=(320, 240))
    pyrs = []
    for f in frames:
        imgs, grads = jpyr.build_pyramid(jnp.asarray(f), levels=4)
        pyrs.append(jpyr.pack_pyramid(imgs, grads))
    quads = np.stack([d.quad for d in dets[0]]).astype(np.float32)
    thetas = []
    for d in dets[0]:
        box = next(b for b in w.boxes if b[2] == d.text)
        thetas.append(torch_synth.plane_theta_in_cam(w.planes[box[0]][0], gt[0]))
    return frames, pyrs, gt, quads, np.stack(thetas)


def _rel_close(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * max(np.abs(b).max(), 1e-12))


def test_extract_text_features(world):
    _, pyrs, _, quads, _ = world
    data = np.asarray(pyrs[0]["data"])
    img, grad = data[1, :120, :160, 0], data[1, :120, :160, 1:3]
    q = quads[0] / 2.0
    ju, jr, jv = jtext.extract_text_features(jnp.asarray(img), jnp.asarray(grad), jnp.asarray(q),
                                             100.0, 30.0, n_feat=64)
    tu, tr, tv = ttext.extract_text_features(T(img), T(grad), T(q), 100.0, 30.0, 64)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert int(tv.sum()) >= 16
    _rel_close(tr.numpy(), jr, 1e-4)


def test_extract_reference_packed(world):
    _, pyrs, _, quads, _ = world
    shapes = np.asarray(pyrs[0]["shapes"], np.int32)
    want = np.asarray(jtext._extract_reference_kernel(
        pyrs[0]["data"], jnp.asarray(shapes), jnp.asarray(quads[1]), n_levels=4, n_feat=64,
        n_box=1024))
    got = ttext._extract_reference(T(np.asarray(pyrs[0]["data"])), shapes, T(quads[1]), 4, 64,
                                   1024).numpy()
    L, F, B = 4, 64, 1024
    o_ref, o_valid = L * F * 2, L * F * 10
    o_ms, o_box = L * F * 11, L * F * 11 + L * 2
    for lo, hi in ((0, o_ref), (o_valid, o_ms), (o_box, o_box + B * 2), (o_box + B * 3, None)):
        np.testing.assert_array_equal(got[lo:hi], want[lo:hi])  # pixels and flags
    for lo, hi in ((o_ref, o_valid), (o_ms, o_box), (o_box + B * 2, o_box + B * 3)):
        _rel_close(got[lo:hi], want[lo:hi], 1e-4)  # intensities and box statistics
    assert got[o_box + B * 3:].sum() > 50  # the ZNCC subsample is populated


def test_seed_features(world):
    _, pyrs, _, quads, _ = world
    data = np.asarray(pyrs[0]["data"])
    img, grad = data[0, :, :, 0], data[0, :, :, 1:3]
    qs = np.concatenate([quads[:3], np.zeros((1, 4, 2), np.float32)])  # a padded slot
    want = np.asarray(jtext._seed_features_kernel(jnp.asarray(img), jnp.asarray(grad),
                                                  jnp.asarray(qs), n_feat=64))
    got = ttext._seed_features(T(img), T(grad), T(qs), 64).numpy()
    np.testing.assert_array_equal(got, want)


def test_gates(world):
    frames, pyrs, gt, quads, thetas = world
    n = len(quads)
    Tt = 8
    q = np.zeros((Tt, 4, 2), np.float32)
    th = np.tile(np.float32([0, 0, -1]), (Tt, 1))
    hp = np.tile(np.float32([1, 0, 0, 0, 0, 0, 0]), (Tt, 1))
    q[:n], th[:n], hp[:n] = quads, thetas, gt[0]
    live = np.arange(Tt) < n
    live[1] = False  # a BAD object
    data = np.asarray(pyrs[0]["data"])
    packed = np.asarray(jtext._extract_reference_kernel(
        pyrs[0]["data"], jnp.asarray(np.asarray(pyrs[0]["shapes"], np.int32)),
        jnp.asarray(quads[0]), n_levels=4, n_feat=64, n_box=256))
    o = 4 * 64 * 11 + 8
    box_uv = np.zeros((Tt, 256, 2), np.float32)
    box_int = np.zeros((Tt, 256), np.float32)
    box_valid = np.zeros((Tt, 256), bool)
    box_uv[:n] = packed[o: o + 512].reshape(256, 2)
    box_int[:n] = packed[o + 512: o + 768]
    box_valid[:n] = packed[o + 768:] > 0.5
    img1 = np.asarray(pyrs[1]["data"])[0, :, :, 0]
    args = (q, th, hp, live, box_uv, box_int, box_valid, img1)
    jg, jf, js = jtext._gates_kernel(jnp.asarray(gt[1]), *map(jnp.asarray, args), FX, FY, CX, CY,
                                     6.0, 0.5, 0.1, width=320, height=240)
    tg, tf, ts = ttext._gates(T(gt[1]), *map(T, args), FX, FY, CX, CY, 6.0, 0.5, 0.1, 320, 240)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert tg.numpy()[:n].sum() >= 2 and not tg.numpy()[1]
    _rel_close(ts.numpy(), js, 1e-4)


def test_theta_ransac_by_outcome():
    rng = np.random.default_rng(6)
    theta = np.float32([0.05, -0.1, -0.3])
    N = 64
    rays = np.concatenate([rng.uniform(-0.4, 0.4, (N, 2)), np.ones((N, 1))], -1).astype(np.float32)
    rhos = -(rays @ theta) * rng.uniform(0.995, 1.005, N).astype(np.float32)
    rhos[:12] *= 1.6  # outliers
    valid = np.arange(N) < 50
    gen = torch.Generator().manual_seed(1)
    tt, tin, tok = ttext._theta_ransac(gen, T(rays), T(rhos), T(valid))
    jt, jin, jok = jtext._theta_ransac_kernel(jax.random.PRNGKey(1), jnp.asarray(rays),
                                              jnp.asarray(rhos), jnp.asarray(valid))
    for th, ok in ((tt.numpy(), bool(tok)), (np.asarray(jt), bool(jok))):
        assert ok
        assert abs(th @ theta) / np.linalg.norm(th) / np.linalg.norm(theta) > 0.999
    np.testing.assert_array_equal(tin.numpy()[12:], np.asarray(jin)[12:])
    # collinear support: both refuse it
    rays[:, 1] = 0.3 * rays[:, 0] + 0.05
    rhos = -(rays @ theta)
    _, _, tok = ttext._theta_ransac(gen, T(rays), T(rhos), T(valid))
    _, _, jok = jtext._theta_ransac_kernel(jax.random.PRNGKey(1), jnp.asarray(rays),
                                           jnp.asarray(rhos), jnp.asarray(valid))
    assert not bool(tok) and not bool(jok)


def test_theta_optimize_all(world):
    """The batched IMMATURE solve: objects hosted in frame 0, observed in
    frames 1 and 2, thetas perturbed from the true planes."""
    _, pyrs, gt, quads, thetas = world
    n = min(len(quads), 4)
    N, Kt, M = 4, 4, 4
    shapes = np.asarray(pyrs[0]["shapes"], np.int32)
    feat_uv = np.zeros((N, 4, 64, 2), np.float32)
    feat_ref = np.zeros((N, 4, 64, 8), np.float32)
    fvk = np.zeros((N, Kt, 4, 64), bool)
    for i in range(n):
        pk = np.asarray(jtext._extract_reference_kernel(
            pyrs[0]["data"], jnp.asarray(shapes), jnp.asarray(quads[i]), n_levels=4, n_feat=64,
            n_box=16))
        feat_uv[i] = pk[: 4 * 64 * 2].reshape(4, 64, 2)
        feat_ref[i] = pk[4 * 64 * 2: 4 * 64 * 10].reshape(4, 64, 8)
        fvk[i, :2] = pk[4 * 64 * 10: 4 * 64 * 11].reshape(4, 64) > 0.5
    rng = np.random.default_rng(2)
    theta0 = np.tile(np.float32([0, 0, -1]), (N, 1))
    theta0[:n] = thetas[:n] * rng.uniform(0.9, 1.1, (n, 3)).astype(np.float32)
    host = np.tile(np.float32([1, 0, 0, 0, 0, 0, 0]), (N, 1))
    host[:n] = gt[0]
    q0 = np.zeros((N, 4, 2), np.float32)
    q0[:n] = quads[:n]
    poses = np.tile(np.float32([1, 0, 0, 0, 0, 0, 0]), (M, 1))
    poses[:2] = gt[1:3]
    tgt_img = np.zeros((N, Kt), np.int32)
    tgt_img[:, 1] = 1
    tgt_valid = np.zeros((N, Kt), bool)
    tgt_valid[:n, :2] = True
    obj_valid = np.arange(N) < n
    levels = (2, 1, 0)
    stacks = []
    for lv in levels:
        h, w = shapes[lv]
        st = np.zeros((M, h, w, 3), np.float32)
        st[0] = np.asarray(pyrs[1]["data"])[lv, :h, :w]
        st[1] = np.asarray(pyrs[2]["data"])[lv, :h, :w]
        stacks.append(st)
    args = (theta0, host, q0, poses, tgt_img, tgt_valid, obj_valid, feat_uv, feat_ref, fvk)
    kw = dict(levels=levels, n_iters=10, huber_theta=2.0, weight_text=5.0)
    jth, jH, jc = jtext.fused_theta_optimize_all(*map(jnp.asarray, args),
                                                 tuple(map(jnp.asarray, stacks)), FX, FY, CX, CY,
                                                 **kw)
    targs = [T(a) for a in args]
    targs[4] = targs[4].long()
    tth, tH, tc = ttext.fused_theta_optimize_all(*targs, tuple(map(T, stacks)), FX, FY, CX, CY,
                                                 **kw)
    np.testing.assert_allclose(tth.numpy(), np.asarray(jth), rtol=1e-3, atol=1e-6)
    _rel_close(tH.numpy(), jH, 1e-3)
    np.testing.assert_allclose(tc.numpy()[:n], np.asarray(jc)[:n], rtol=1e-3)
