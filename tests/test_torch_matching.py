"""Port descriptor matching held against the JAX package.

Everything here is integer-valued (Hamming distances, indices, masks), so
every comparison is exact. The CUDA kernel itself runs only on the GPU
(chip_smoke.py holds it against the plain version there); here the plain
versions are held against the JAX XLA path and against the Pallas kernel in
interpret mode, the launch checks are exercised, and the CUDA path is shown
to raise rather than fall back.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from textslam_tpu.ops import matching as jm
from textslam_tpu.ops import pallas_kernels as pk
from textslam_tpu_torch.ops import cuda_lib
from textslam_tpu_torch.ops import matching as tm

torch.set_num_threads(2)


def _desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


def _t(d):
    """uint32 descriptor words -> the port's int32 bit layout."""
    return torch.as_tensor(np.ascontiguousarray(d).view(np.int32))


def _xla_hamming(d1, d2):
    x = jnp.bitwise_xor(jnp.asarray(d1)[:, None, :], jnp.asarray(d2)[None, :, :])
    return np.asarray(jax.lax.population_count(x).astype(jnp.int32).sum(-1))


@pytest.mark.parametrize("shape", [(1, 1), (200, 300), (257, 129)])
def test_plain_hamming_equals_xla(shape):
    rng = np.random.default_rng(shape[0])
    d1, d2 = _desc(rng, shape[0]), _desc(rng, shape[1])
    d1[0] = 0xFFFFFFFF  # all-ones words: the sign bit of every int32
    got = tm.hamming_matrix(_t(d1), _t(d2))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _xla_hamming(d1, d2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jm.hamming_matrix(jnp.asarray(d1), jnp.asarray(d2))))


@pytest.mark.parametrize("shape", [(1, 1), (17, 9), (257, 129)])
def test_hamming_min_equals_jax(shape):
    """The alternate-descriptor minimum (one launch on the card) against the
    JAX package's two matrices and jnp.minimum, with all-ones and all-zero
    rows in every row set."""
    n1, n2 = shape
    rng = np.random.default_rng(100 + n1)
    d1, d1_alt, d2 = _desc(rng, n1), _desc(rng, n1), _desc(rng, n2)
    d1[0], d2[0] = 0xFFFFFFFF, 0
    d1_alt[-1], d2[-1] = 0, 0xFFFFFFFF
    if n1 > 2:
        d1[1], d1_alt[2] = 0, 0xFFFFFFFF
    got = tm.hamming_matrix_min(_t(d1), _t(d1_alt), _t(d2))
    want = jnp.minimum(jm.hamming_matrix(jnp.asarray(d1), jnp.asarray(d2)),
                       jm.hamming_matrix(jnp.asarray(d1_alt), jnp.asarray(d2)))
    assert got.dtype == torch.int32 and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tm.hamming_matrix_min_plain(_t(d1), _t(d1_alt), _t(d2)).numpy(),
                                  np.asarray(want))


def test_plain_hamming_chunked_rows():
    rng = np.random.default_rng(9)
    d1, d2 = _desc(rng, 50), _desc(rng, 40)
    got = tm.hamming_matrix_plain(_t(d1), _t(d2), chunk_elems=7 * 40 * 8)
    np.testing.assert_array_equal(got.numpy(), _xla_hamming(d1, d2))


def test_plain_hamming_equals_pallas_interpret():
    """The TPU kernel body run in Pallas interpret mode, as
    tests/test_ops_features.py::TestPallasHamming runs it."""
    rng = np.random.default_rng(0)
    d1, d2 = _desc(rng, 200), _desc(rng, 300)
    T = pk.TILE
    P1 = (200 + T - 1) // T * T
    P2 = (300 + T - 1) // T * T
    d1t = jnp.pad(jnp.asarray(d1), ((0, P1 - 200), (0, 0))).T
    d2t = jnp.pad(jnp.asarray(d2), ((0, P2 - 300), (0, 0))).T
    out = pl.pallas_call(
        pk._hamming_kernel,
        out_shape=jax.ShapeDtypeStruct((P1, P2), jnp.int32),
        grid=(P1 // T, P2 // T),
        in_specs=[
            pl.BlockSpec((8, T), lambda i, j: (0, i)),
            pl.BlockSpec((8, T), lambda i, j: (0, j)),
        ],
        out_specs=pl.BlockSpec((T, T), lambda i, j: (i, j)),
        interpret=True,
    )(d1t, d2t)
    np.testing.assert_array_equal(tm.hamming_matrix(_t(d1), _t(d2)).numpy(),
                                  np.asarray(out)[:200, :300])


def _tie_heavy(rng, n1, n2):
    """Descriptors drawn from a tiny pool of base words with few flipped
    bits, so distances collide constantly."""
    base = _desc(rng, 40)
    d1 = base[rng.integers(0, 40, n1)].copy()
    d2 = base[rng.integers(0, 40, n2)].copy()
    flip = rng.integers(0, 4, (n2, 8)).astype(np.uint32)
    d2 ^= (1 << flip).astype(np.uint32) * (rng.uniform(size=(n2, 8)) < 0.3)
    return d1, d2


@pytest.mark.parametrize("case", ["plain", "pair_ratio", "alt", "alt_pair_ratio"])
def test_mutual_best_match_ties_exact(case):
    rng = np.random.default_rng(len(case))
    n1, n2 = 150, 120
    d1, d2 = _tie_heavy(rng, n1, n2)
    d1_alt = _tie_heavy(rng, n1, n2)[0]
    v1 = rng.uniform(size=n1) < 0.9
    v2 = rng.uniform(size=n2) < 0.9
    pair = rng.uniform(size=(n1, n2)) < 0.4
    kw_j, kw_t = {}, {}
    if "pair" in case:
        kw_j.update(pair_mask=jnp.asarray(pair), ratio=0.9)
        kw_t.update(pair_mask=torch.as_tensor(pair), ratio=0.9)
    if "alt" in case:
        kw_j["d1_alt"] = jnp.asarray(d1_alt)
        kw_t["d1_alt"] = _t(d1_alt)
    ij, okj = jm.mutual_best_match(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1),
                                   jnp.asarray(v2), max_dist=20, **kw_j)
    it, okt = tm.mutual_best_match(_t(d1), _t(d2), torch.as_tensor(v1),
                                   torch.as_tensor(v2), max_dist=20, **kw_t)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert okt.sum() > 10


def test_masked_best2_and_masks_exact():
    rng = np.random.default_rng(11)
    dist = rng.integers(0, 6, (40, 30)).astype(np.int32)
    mask = rng.uniform(size=(40, 30)) < 0.5
    mask[3] = False  # a row with no candidate: all INF
    for a, b in zip(tm.masked_best2(torch.as_tensor(dist), torch.as_tensor(mask)),
                    jm.masked_best2(jnp.asarray(dist), jnp.asarray(mask))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    uv1 = rng.uniform(0, 100, (40, 2)).astype(np.float32)
    uv2 = rng.uniform(0, 100, (30, 2)).astype(np.float32)
    r = rng.uniform(5, 30, 40).astype(np.float32)
    np.testing.assert_array_equal(
        tm.window_mask(torch.as_tensor(uv1), torch.as_tensor(uv2), torch.as_tensor(r)).numpy(),
        np.asarray(jm.window_mask(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(r))))
    np.testing.assert_array_equal(
        tm.window_mask(torch.as_tensor(uv1), torch.as_tensor(uv2), 12.0).numpy(),
        np.asarray(jm.window_mask(jnp.asarray(uv1), jnp.asarray(uv2), 12.0)))
    l1 = rng.integers(0, 8, 40).astype(np.int32)
    l2 = rng.integers(0, 8, 30).astype(np.int32)
    for md in (0, 1, None):
        np.testing.assert_array_equal(
            tm.level_mask(torch.as_tensor(l1), torch.as_tensor(l2), md).numpy(),
            np.asarray(jm.level_mask(jnp.asarray(l1), jnp.asarray(l2), md)))


def test_rotation_histogram_filter_exact():
    rng = np.random.default_rng(12)
    n = 100
    a1 = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    a2 = (a1 - 0.3).astype(np.float32)
    a2[:30] = rng.uniform(0, 2 * np.pi, 30)
    idx = rng.permutation(n)
    a2 = a2[np.argsort(idx)]  # so that a2[idx] lines up with a1
    ok = rng.uniform(size=n) < 0.8
    got = tm.rotation_histogram_filter(torch.as_tensor(a1), torch.as_tensor(a2),
                                       torch.as_tensor(idx), torch.as_tensor(ok))
    want = jm.rotation_histogram_filter(jnp.asarray(a1), jnp.asarray(a2),
                                        jnp.asarray(idx), jnp.asarray(ok))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrapper_rejects_bad_inputs():
    d = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        tm.hamming_matrix(d.to(torch.int64), d)
    with pytest.raises(ValueError):
        tm.hamming_matrix(torch.zeros((4, 7), dtype=torch.int32), d)
    with pytest.raises(ValueError):
        tm.hamming_matrix(torch.zeros((8, 4), dtype=torch.int32).t(), d)


def test_launch_args_checks():
    d = torch.zeros((4, 8), dtype=torch.int32)
    assert tm.launch_args(d, torch.zeros((3, 8), dtype=torch.int32)) == (4, 3)
    assert tm.launch_args(d, d[:2], d1_alt=d.clone()) == (4, 2)
    bad = [
        ((d.to(torch.int64), d), {}, TypeError),  # dtype
        ((d.numpy(), d), {}, TypeError),  # not a tensor
        ((torch.zeros((4, 7), dtype=torch.int32), d), {}, ValueError),  # words
        ((torch.zeros((4, 8, 1), dtype=torch.int32), d), {}, ValueError),  # rank
        ((torch.zeros((8, 4), dtype=torch.int32).t(), d), {}, ValueError),  # stride
        ((d, d), {"d1_alt": torch.zeros((8, 4), dtype=torch.int32).t()}, ValueError),
        ((d, d), {"d1_alt": d[:3]}, ValueError),  # d1_alt not of d1's shape
        ((d, d), {"d1_alt": d.to(torch.int64)}, TypeError),
        ((d, torch.zeros((4, 8), dtype=torch.int32, device="meta")), {}, ValueError),  # device
        ((d, d), {"d1_alt": torch.zeros((4, 8), dtype=torch.int32, device="meta")}, ValueError),
        ((torch.zeros(33, dtype=torch.int32)[1:].view(4, 8), d), {}, ValueError),  # 4-byte aligned
    ]
    for args, kw, err in bad:
        with pytest.raises(err):
            tm.launch_args(*args, **kw)
    rows = torch.zeros((tm._MAX_ROWS + 1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="rows"):
        tm.launch_args(rows, d.to("meta"))
    assert tm.launch_args(rows[:-1], d.to("meta")) == (tm._MAX_ROWS, 4)


@pytest.mark.parametrize("entry", ["hamming_matrix", "hamming_matrix_min"])
def test_non_cpu_path_raises_instead_of_falling_back(monkeypatch, tmp_path, entry):
    """A device other than the CPU never takes the plain version: without a
    kernel it raises, and the CUDA path raises when nvcc is missing, before
    anything is counted as a launch."""
    before = tm.hamming_matrix.launches
    meta = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        if entry == "hamming_matrix":
            tm.hamming_matrix(meta, meta)
        else:
            tm.hamming_matrix_min(meta, meta, meta)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_lib, "_LIBS", {})
    monkeypatch.setattr(cuda_lib.os.path, "isfile",
                        lambda p: False if p.endswith("nvcc") else True)
    d = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="nvcc"):
        tm._hamming_cuda(d, d, None if entry == "hamming_matrix" else d.clone())
    assert tm.hamming_matrix.launches == before
