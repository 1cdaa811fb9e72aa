"""The grouped region sampler of the text residuals: the port's plain
version (the CPU path of ops.patch_sample.grouped_bilinear_stack) against
the JAX package's Pallas kernel run in interpret mode at
precision=HIGHEST, and the port's _sample_text_values against JAX's CPU
path (per-feature 8x8 patches) where the region covers every sample.

Tolerances and why:
- masks exactly equal: both compute the same comparisons on the same
  float32 coordinates;
- values within 1e-4 absolute on images in [0, 255]: the Pallas kernel
  contracts one-hot weights in a float32 matmul, the port lerps the four
  corners; both are exact bilinear weights, rounded in another order
  (float32 eps at 255 is 1.5e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textslam_tpu.ops import pallas_kernels as pk
from textslam_tpu.ops.interp import bilinear_stack as jbilinear_stack
from textslam_tpu.solver import ba as jba
from textslam_tpu_torch.ops import cuda_lib, patch_sample
from textslam_tpu_torch.solver import ba as tba

torch.set_num_threads(2)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pk.pl, "pallas_call", patched)


def _both(imgs, group_k, uv, **kw):
    jv, jm = pk.grouped_bilinear_stack(jnp.asarray(imgs), jnp.asarray(group_k),
                                       jnp.asarray(uv), precision=jax.lax.Precision.HIGHEST, **kw)
    tv, tm = patch_sample.grouped_bilinear_stack(torch.from_numpy(imgs),
                                                 torch.from_numpy(group_k).long(),
                                                 torch.from_numpy(uv), **kw)
    return np.asarray(jv), np.asarray(jm), tv.numpy(), tm.numpy()


def _check_equal(jv, jm, tv, tm):
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4)
    assert float(np.abs(tv[~tm]).max(initial=0.0)) == 0.0


def _clusters(rng, G, Q, H, W, s):
    """G clusters of Q samples, each within +-s of a centre inside the image."""
    cx = rng.uniform(s + 2, W - s - 2, (G, 1))
    cy = rng.uniform(s + 2, H - s - 2, (G, 1))
    return np.stack([cx + rng.uniform(-s, s, (G, Q)), cy + rng.uniform(-s, s, (G, Q))], -1)


def _uv_all_off_image(rng, G, Q, H, W):
    """Group 1 has no in-image sample (NaN, left of and below the image)."""
    uv = _clusters(rng, G, Q, H, W, 8.0)
    uv[1, 0::3] = np.nan
    uv[1, 1::3] = [-2.0, 5.0]
    uv[1, 2::3] = [W + 1.0, H + 1.0]
    return uv


def _uv_tile_boundary(rng, G, Q, H, W):
    """Minima exactly on and just below a 128-px / 8-row tile boundary, and
    samples on and just past a region's last column."""
    uv = np.stack([rng.uniform(130, 300, (G, Q)), rng.uniform(16, 30, (G, Q))], -1)
    uv[0, 0, 0] = 128.0  # ox = 128
    uv[0, 1, 0] = 383.0  # ox + RW - 1: kept
    uv[0, 2, 0] = np.nextafter(np.float32(383.0), np.float32(400.0))  # just past: masked
    uv[1, 0, 0] = 127.99998  # ox = 0
    uv[2, 0, 1] = 8.0  # oy = 8
    uv[3, 0, 1] = 7.9999995  # oy = 0
    return uv


def _uv_last_tile(rng, G, Q, H, W):
    """A box in the bottom-right corner: both origins clamp to the last
    tile (oy = H8 - RH, ox = W128 - RW); the last pixel exactly."""
    uv = np.stack([rng.uniform(520, W - 1, (G, Q)), rng.uniform(330, H - 1, (G, Q))], -1)
    uv[0, 0] = [W - 1, H - 1]
    return uv


def _uv_width_only_full(rng, G, Q, H, W):
    """A full-width level (W128 <= region_w, H8 > region_h): samples across
    the width with min u > 128 still take ox = 0; rows snap to oy = 40."""
    uv = np.stack([rng.uniform(140, W - 1, (G, Q)), rng.uniform(40.5, 100, (G, Q))], -1)
    uv[:, 0, 1] = 40.5
    uv[0, 1, 0] = W - 1  # the pad column is read with weight 0
    return uv


def _uv_inf(rng, G, Q, H, W):
    """+-inf coordinates (nan_to_num: +-1e6, off the image); group 2 has
    nothing else."""
    uv = _clusters(rng, G, Q, H, W, 8.0)
    uv[0, 0] = [np.inf, 5.0]
    uv[0, 1] = [-np.inf, 5.0]
    uv[1, 2] = [10.0, np.inf]
    uv[1, 3] = [10.0, -np.inf]
    uv[2, 0::2] = [np.inf, -np.inf]
    uv[2, 1::2] = [-np.inf, np.inf]
    return uv


CASES = {
    # clustered samples with a region smaller than the level, plus an
    # off-image sample, a NaN projection and samples beyond the region
    "region": dict(shape=(3, 64, 96, 3), G=5, Q=16, region=(32, 64), spread=8.0, edge=True),
    # a level whose padded extent fits the region: origin 0, whole image
    "full_image": dict(shape=(2, 24, 40, 3), G=3, Q=8, region=(160, 384), spread=None, edge=False),
    # 640x480 level 0 with samples at the right/bottom border: origins clamp
    # to the last aligned tile, and u = W-1 / v = H-1 read past the image
    "origin_alignment": dict(shape=(1, 480, 640, 3), G=2, Q=12, region=(160, 384), spread=None,
                             edge=True),
    # a full-width level (W128 > W): the pad column is read with weight 0
    "full_width": dict(shape=(2, 240, 320, 3), G=4, Q=24, region=(160, 384), spread=20.0,
                       edge=True),
    # the region cases the kernel computes itself, each with the origins
    # (oy, ox) it must give: a group without any in-image sample
    "all_off_image": dict(shape=(2, 64, 96, 3), G=3, Q=16, region=(32, 64), make=_uv_all_off_image,
                          origins={1: (0, 0)}),
    # minima on / below tile boundaries (W128 = 512, RW = 256; RH = 16)
    "tile_boundary": dict(shape=(2, 40, 400, 3), G=4, Q=16, region=(16, 256), make=_uv_tile_boundary,
                          origins={0: (16, 128), 1: (16, 0), 2: (8, 128), 3: (0, 128)}),
    # 640x480 level 0, both origins clamped to the last tile
    "last_tile_clamp": dict(shape=(1, 480, 640, 3), G=2, Q=12, region=(160, 384), make=_uv_last_tile,
                            origins={0: (320, 256), 1: (320, 256)}),
    # 640x480 level 1: only the width is full
    "width_only_full": dict(shape=(2, 240, 320, 3), G=3, Q=24, region=(160, 384),
                            make=_uv_width_only_full, origins={0: (40, 0), 1: (40, 0), 2: (40, 0)}),
    "inf": dict(shape=(2, 64, 96, 3), G=3, Q=16, region=(32, 64), make=_uv_inf,
                origins={2: (0, 0)}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret(case, interpret_pallas):
    c = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    K, H, W, C = c["shape"]
    imgs = rng.uniform(0, 255, (K, H, W, C)).astype(np.float32)
    G, Q = c["G"], c["Q"]
    group_k = rng.integers(0, K, G).astype(np.int32)
    if "make" in c:
        uv = c["make"](rng, G, Q, H, W)
    elif c["spread"] is None:
        uv = np.stack([rng.uniform(W - 60, W - 1, (G, Q)), rng.uniform(H - 60, H - 1, (G, Q))], -1)
    else:
        uv = _clusters(rng, G, Q, H, W, c["spread"])
    uv = uv.astype(np.float32)
    if c.get("edge"):
        uv[0, 0] = [-5.0, 3.0]  # off-image
        uv[1, 1] = [np.nan, np.nan]  # broken projection
        uv[0, 2] = [W - 1, H - 1]  # the last pixel exactly
        uv[1, 2] = [W - 1, 2.5]
        uv[0, 3] = [1.5, H - 1]
        uv[0, 4] = [uv[0, 5, 0] + 300.0, uv[0, 5, 1]]  # beyond the region
    rh, rw = c["region"]
    _check_equal(*_both(imgs, group_k, uv, region_h=rh, region_w=rw))
    _, meta, mask, _, _ = patch_sample.regions(torch.from_numpy(imgs), torch.from_numpy(group_k).long(),
                                               torch.from_numpy(uv), rh, rw)
    for g, origin in c.get("origins", {}).items():
        assert tuple(meta[g, 1:].tolist()) == origin, (case, g)
    if case in ("all_off_image", "inf"):
        assert not mask[max(c["origins"])].any()


# 640x480 pyramid levels 0-3 at the 160x384 region:
# (RH, RW, H8, W128, full_h, full_w)
LEVEL_ARGS = {0: (160, 384, 480, 640, 0, 0), 1: (160, 384, 240, 384, 0, 1),
              2: (120, 256, 120, 256, 1, 1), 3: (64, 128, 64, 128, 1, 1)}


@pytest.mark.parametrize("level", sorted(LEVEL_ARGS))
def test_launch_args_levels(level):
    """The kernel's scalar arguments for a level of a frame's packed
    pyramid read in place, with the strided group_k view that
    _sample_text_values passes (tgt.reshape(G, pair_feat)[:, 0]); the plain
    version gives the same samples for that view and its copy."""
    H, W = 480 >> level, 640 >> level
    packed = torch.from_numpy(np.random.default_rng(level).uniform(
        0, 255, (4, 480, 640, 3)).astype(np.float32))
    imgs = packed[level, :H, :W][None]
    G, F, S = 5, 64, 8
    tgt = torch.zeros(G * F, dtype=torch.int64)
    group_k = tgt.reshape(G, F)[:, 0]
    uv = torch.from_numpy(np.random.default_rng(9).uniform(
        0, [W - 1, H - 1], (G, F * S, 2)).astype(np.float32))
    a = patch_sample.launch_args(imgs, group_k, uv)
    assert (a.RH, a.RW, a.H8, a.W128) == patch_sample.region_shape(H, W, 160, 384)
    assert (a.RH, a.RW, a.H8, a.W128, a.full_h, a.full_w) == LEVEL_ARGS[level]
    assert (a.img_stride, a.row_stride, a.k_stride) == (imgs.stride(0), 640 * 3, F)
    assert (a.G, a.Q, a.H, a.W) == (G, F * S, H, W)
    # the C entry point takes 5 pointers, these arguments packed as its
    # 64-byte LaunchArgs struct, and the stream
    assert len(cuda_lib.SIGNATURES[("patch_sample", "patch_sample_launch")]) == 5 + 1 + 1
    assert patch_sample.PACK.size == 64
    assert patch_sample.PACK.unpack(patch_sample.PACK.pack(*a)) == tuple(a)
    v1, m1 = patch_sample.grouped_bilinear_stack(imgs, group_k, uv)
    v2, m2 = patch_sample.grouped_bilinear_stack(imgs.contiguous(), group_k.contiguous(), uv)
    assert torch.equal(m1, m2) and torch.equal(v1, v2)


def test_kernel_layout_read_in_place():
    """A packed pyramid level slice (row stride > width) is sampled in
    place and agrees with the same level copied out contiguously."""
    rng = np.random.default_rng(5)
    packed = torch.from_numpy(rng.uniform(0, 255, (2, 48, 80, 3)).astype(np.float32))
    level = packed[1, :24, :40][None]
    assert not level.is_contiguous()
    uv = torch.from_numpy(rng.uniform(0, 39, (3, 16, 2)).astype(np.float32))
    k = torch.zeros(3, dtype=torch.int64)
    v1, m1 = patch_sample.grouped_bilinear_stack(level, k, uv)
    v2, m2 = patch_sample.grouped_bilinear_stack(level.contiguous(), k, uv)
    assert torch.equal(m1, m2) and torch.equal(v1, v2)


def test_plain_agrees_with_jax_bilinear_where_covered():
    """Where the mask is set, the grouped samples equal plain bilinear
    samples of the same image (the sampler's contract, independent of the
    Pallas kernel): float32 lerp vs lerp, 1e-4 absolute."""
    rng = np.random.default_rng(3)
    imgs = rng.uniform(0, 255, (2, 120, 160, 3)).astype(np.float32)
    k = np.array([0, 1, 1], np.int32)
    uv = np.stack([rng.uniform(10, 150, (3, 32)), rng.uniform(10, 110, (3, 32))], -1).astype(np.float32)
    tv, tm = patch_sample.grouped_bilinear_stack(torch.from_numpy(imgs), torch.from_numpy(k).long(),
                                                 torch.from_numpy(uv))
    jv, jm = jbilinear_stack(jnp.asarray(imgs), jnp.asarray(k)[:, None], jnp.asarray(uv))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-4)


def test_sample_text_values_matches_jax_cpu_path():
    """The port always takes the grouped contract when pair_feat > 0; JAX on
    the CPU takes per-feature patches. On boxes inside the region the two
    masks agree and no sample is dropped, so the values agree too."""
    rng = np.random.default_rng(4)
    K, H, W = 3, 240, 320
    imgs = rng.uniform(0, 255, (K, H, W, 3)).astype(np.float32)
    pairs, F = 6, 8
    tgt = np.repeat(rng.integers(0, K, pairs), F).astype(np.int32)
    centers = np.repeat(np.stack([rng.uniform(40, 280, pairs), rng.uniform(40, 200, pairs)], -1), F, 0)
    feat = centers + rng.uniform(-30, 30, (pairs * F, 2))
    offs = np.array([[0, 0], [2, 0], [-2, 0], [0, 2], [0, -2], [1, -1], [-1, 1], [-1, -1]])
    uv = (feat[:, None, :] + offs[None]).astype(np.float32)
    uv[3, 2] = [-4.0, 10.0]  # one off-image sample, masked by both
    jv, jm = jba._sample_text_values(jnp.asarray(imgs), jnp.asarray(tgt), jnp.asarray(uv), F)
    tv, tm = tba._sample_text_values(torch.from_numpy(imgs), torch.from_numpy(tgt).long(),
                                     torch.from_numpy(uv), F)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert not tm[3, 2] and int(tm.sum()) == uv.shape[0] * 8 - 1
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-4)


def test_cuda_path_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal cannot be shown here")
    imgs = torch.zeros((1, 16, 16, 3))
    with pytest.raises((RuntimeError, AssertionError)):
        patch_sample.grouped_bilinear_stack(imgs.to("cuda"), torch.zeros(1, dtype=torch.int64),
                                            torch.zeros((1, 4, 2)))
    # a tensor on neither the CPU nor a GPU never reaches the plain version
    meta = dict(device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        patch_sample.grouped_bilinear_stack(torch.zeros((1, 16, 16, 3), **meta),
                                            torch.zeros(1, dtype=torch.int64, **meta),
                                            torch.zeros((1, 4, 2), **meta))


def test_wrapper_rejects_bad_inputs():
    imgs = torch.zeros((1, 16, 16, 3))
    k = torch.zeros(1, dtype=torch.int64)
    uv = torch.zeros((1, 4, 2))
    with pytest.raises(TypeError):
        patch_sample.grouped_bilinear_stack(imgs.double(), k, uv)
    with pytest.raises(ValueError):
        patch_sample.grouped_bilinear_stack(imgs.permute(0, 3, 1, 2), k, uv)
    with pytest.raises(ValueError):
        patch_sample.grouped_bilinear_stack(imgs, k, torch.zeros((1, 2, 4)).transpose(1, 2))
    with pytest.raises(ValueError):
        patch_sample.grouped_bilinear_stack(imgs, torch.zeros(2, dtype=torch.int64), uv)
    with pytest.raises(TypeError):  # the path's image indices are int64
        patch_sample.grouped_bilinear_stack(imgs, k.int(), uv)
    with pytest.raises(ValueError):  # the stack is (I, sobel-x, sobel-y)
        patch_sample.grouped_bilinear_stack(imgs[..., :2].contiguous(), k, uv)
