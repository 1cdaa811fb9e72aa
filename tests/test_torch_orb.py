"""Port frame-build ops (FAST, NMS, ORB, BRIEF, keypoint packing) held
against the JAX package on the CPU.

Tolerances and why:
- FAST scores, NMS, the 7x7 blur and keypoint selection are exact: the port
  evaluates the same float32 operations in the same order (min/max chains,
  taps summed tap 0 first), and selection breaks ties by lower index like
  XLA's top_k.
- IC-angle moments are 961-term float32 sums whose order XLA chooses, so
  angles agree to ~1e-5 rad, not bit for bit. A BRIEF pair whose rotated
  offset lands within that much of a .5 rounding boundary can flip, so
  full-pipeline descriptors are compared with a bound; given the same
  angles, the descriptors are exact.
- Levels >= 1 come from an antialiased bilinear resize (XLA vs ATen): pixel
  values agree to ~1e-4 gray, which can move a FAST score across a tie, so
  mismatches there are bounded, not zero.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textslam_tpu.ops import fast as jfast
from textslam_tpu.ops import orb as jorb
from textslam_tpu_torch.ops import fast as tfast
from textslam_tpu_torch.ops import orb as torb

import torch_synth

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def image():
    """A 160x120 render of the textured plane world (cv2-free renderer)."""
    world = torch_synth.PlaneWorld(seed=0)
    K = torch_synth.K.copy()
    K[:2] /= 4.0
    pose = torch_synth.camera_path(3)[1]
    return world.render(pose, K_mat=K, size=(160, 120))


@pytest.mark.parametrize("threshold", [7.0, 20.0])
def test_fast_score_map_exact(image, threshold):
    t = tfast.fast_score_map(torch.as_tensor(image), threshold).numpy()
    j = np.asarray(jfast.fast_score_map(jnp.asarray(image), threshold))
    np.testing.assert_array_equal(t, j)
    assert (t > 0).sum() > 50


def test_nms3_exact(image):
    s = np.asarray(jfast.fast_score_map(jnp.asarray(image), 7.0))
    np.testing.assert_array_equal(tfast.nms3(torch.as_tensor(s)).numpy(),
                                  np.asarray(jfast.nms3(jnp.asarray(s))))


def test_gauss_blur7_exact(image):
    np.testing.assert_array_equal(torb.gauss_blur7(torch.as_tensor(image)).numpy(),
                                  np.asarray(jorb.gauss_blur7(jnp.asarray(image))))


def test_select_keypoints_ties_exact():
    """Integer scores make ties the normal case; the port must pick the same
    keypoints in the same order as XLA's top_k."""
    rng = np.random.default_rng(1)
    score = rng.integers(0, 4, (70, 90)).astype(np.float32)
    score[rng.uniform(size=score.shape) < 0.5] = 0.0
    for n_keep in (10, 200, 2000):
        t = torb.select_keypoints(torch.as_tensor(score), n_keep, cell=16)
        j = jorb.select_keypoints(jnp.asarray(score), n_keep, cell=16)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_brief_pattern_equal():
    np.testing.assert_array_equal(torb.BRIEF_PATTERN, jorb.BRIEF_PATTERN)
    np.testing.assert_array_equal(torb.CIRC_MASK, jorb.CIRC_MASK)


def test_orientation_and_descriptors(image):
    rng = np.random.default_rng(2)
    uv = np.stack([rng.integers(20, 140, 100), rng.integers(20, 100, 100)], -1).astype(np.float32)
    at = torb.ic_angle(torch.as_tensor(image), torch.as_tensor(uv)).numpy()
    aj = np.asarray(jorb.ic_angle(jnp.asarray(image), jnp.asarray(uv)))
    np.testing.assert_allclose(at, aj, atol=1e-4)  # summation order, see module doc
    blurred = np.asarray(jorb.gauss_blur7(jnp.asarray(image)))
    dt = torb.brief_descriptors(torch.as_tensor(blurred), torch.as_tensor(uv), torch.as_tensor(aj))
    dj = np.asarray(jorb.brief_descriptors(jnp.asarray(blurred), jnp.asarray(uv), jnp.asarray(aj)))
    np.testing.assert_array_equal(dt.numpy(), dj.view(np.int32))


def test_resize_matches_jax_antialias():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (83, 111), method="bilinear"))
    got = torch.nn.functional.interpolate(
        torch.as_tensor(img)[None, None], size=(83, 111), mode="bilinear",
        antialias=True, align_corners=False)[0, 0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)


def _bit_diff(a, b):
    return np.unpackbits((a ^ b).view(np.uint8), axis=-1).sum(-1)


def test_extract_orb(image):
    kt = torb.extract_orb(torch.as_tensor(image), n_features=300)
    kj = jorb.extract_orb(jnp.asarray(image), n_features=300)
    lv = np.asarray(kj.level)
    np.testing.assert_array_equal(kt.level.numpy(), lv)
    l0 = lv == 0
    assert l0.sum() > 30
    # level 0: the same pixels, scores and validity
    for f in ("uv", "score", "valid"):
        np.testing.assert_array_equal(getattr(kt, f).numpy()[l0], np.asarray(getattr(kj, f))[l0])
    np.testing.assert_allclose(kt.angle.numpy()[l0], np.asarray(kj.angle)[l0], atol=1e-4)
    # descriptors: rows whose bits differ only through the angle's rounding
    bits = _bit_diff(kt.desc.numpy().view(np.uint32), np.asarray(kj.desc))
    assert (bits[l0] > 0).mean() <= 0.05, bits[l0]
    assert bits[l0].max() <= 16, bits[l0]
    # all levels: keypoint locations agree up to the resize rounding bound
    same_uv = (kt.uv.numpy() == np.asarray(kj.uv)).all(-1)
    assert same_uv.mean() >= 0.9, same_uv.mean()
    assert (bits[same_uv] > 0).mean() <= 0.05


def test_pack_unpack_keeps_bits():
    """Descriptor words whose bits are NaN / denormal floats must survive
    the float32 packing untouched."""
    rng = np.random.default_rng(4)
    n = 64
    desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    desc[0] = [0x7FC00001, 0xFF800001, 0x7F800001, 0x00000001,
               0x80000001, 0x7FFFFFFF, 0xFFFFFFFF, 0x80000000]
    kp = torb.Keypoints(
        uv=torch.as_tensor(rng.uniform(0, 600, (n, 2)).astype(np.float32)),
        uv_level=torch.zeros(n, 2),
        level=torch.as_tensor(rng.integers(0, 8, n).astype(np.int32)),
        angle=torch.as_tensor(rng.uniform(-3, 3, n).astype(np.float32)),
        score=torch.as_tensor(rng.uniform(0, 90, n).astype(np.float32)),
        desc=torch.as_tensor(desc.view(np.int32)),
        valid=torch.as_tensor(rng.uniform(size=n) < 0.7),
    )
    packed = torb.pack_keypoints(kp, kp)
    assert packed.dtype == torch.float32 and packed.shape == (2 * n, 14)
    uv, level, angle, score, valid, d = torb.unpack_keypoints_np(packed.numpy())
    np.testing.assert_array_equal(d[:n], desc)
    np.testing.assert_array_equal(d[n:], desc)
    np.testing.assert_array_equal(torb.packed_desc(packed).numpy()[:n], desc.view(np.int32))
    np.testing.assert_array_equal(uv[:n], kp.uv.numpy())
    np.testing.assert_array_equal(level[:n], kp.level.numpy())
    np.testing.assert_array_equal(valid[:n], kp.valid.numpy())
    # the JAX decoder reads the port's packing identically
    jd = jorb.unpack_keypoints_np(packed.numpy())
    np.testing.assert_array_equal(jd[5], d)
