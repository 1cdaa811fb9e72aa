"""Port Levenshtein (textslam_tpu_torch.ops.levenshtein) held against the
JAX package: exact integer distances from the device wavefront at the
padded tiers L = 16, 32 and 64 (empty, identical, CJK and random strings),
and the host DP (the plain version of the port's native routine) against
the JAX package's native levenshtein_batch at L = 128. Similarity scores to
1e-6 (one float32 division)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from textslam_tpu import native
from textslam_tpu.ops import levenshtein as jlev
from textslam_tpu_torch import native as tnative
from textslam_tpu_torch.ops import levenshtein as tlev

torch.set_num_threads(2)

ALPHA = list("ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-#") + list("咖啡店出口酒店東京駅")


def _words(rng, n, max_len):
    out = ["", "EXIT", "EXIT", "咖啡店", "咖啡廳", "HOTEL-出口"]
    while len(out) < n:
        k = int(rng.integers(1, max_len + 1))
        out.append("".join(rng.choice(ALPHA, k)))
    return [w[:max_len] for w in out]


def _mutate(rng, words):
    """Near copies: one or two edits of each word."""
    out = []
    for w in words:
        w = list(w)
        for _ in range(int(rng.integers(1, 3))):
            op = int(rng.integers(3))
            i = int(rng.integers(len(w) + 1))
            if op == 0 or not w:
                w.insert(i, str(rng.choice(ALPHA)))
            elif op == 1:
                del w[min(i, len(w) - 1)]
            else:
                w[min(i, len(w) - 1)] = str(rng.choice(ALPHA))
        out.append("".join(w))
    return out


@pytest.mark.parametrize("L", [16, 32, 64])
def test_device_matrix_exact(L):
    rng = np.random.default_rng(L)
    q = _words(rng, 12, L)
    t = q[:4] + _mutate(rng, q[4:]) + _words(rng, 10, L)
    t = [w[:L] for w in t]
    qa, qlen = jlev.encode(q, L)
    ta, tlen = jlev.encode(t, L)
    qa_t, qlen_t = tlev.encode(q, L)
    np.testing.assert_array_equal(qa_t, qa)
    np.testing.assert_array_equal(qlen_t, qlen)
    dj = np.asarray(jlev.levenshtein_matrix(jnp.asarray(qa), jnp.asarray(qlen),
                                            jnp.asarray(ta), jnp.asarray(tlen)))
    dt = tlev.levenshtein_matrix(torch.tensor(qa), torch.tensor(qlen), torch.tensor(ta),
                                 torch.tensor(tlen))
    assert dt.dtype == torch.int32
    np.testing.assert_array_equal(dt.numpy(), dj)
    assert dt[0, 0] == 0 and dt[1, 2] == 0  # empty vs empty, identical words
    sj = np.asarray(jlev.similarity_scores(jnp.asarray(dj), jnp.asarray(qlen), jnp.asarray(tlen)))
    st = tlev.similarity_scores(dt, torch.tensor(qlen), torch.tensor(tlen))
    np.testing.assert_allclose(st.numpy(), sj, rtol=1e-6, atol=1e-7)


def test_host_dp_matches_native_at_128():
    rng = np.random.default_rng(128)
    L = 128
    q = _words(rng, 6, 100) + ["ESTABLISHED-1927-GRAND-CENTRAL-HARDWARE" * 3]
    t = _mutate(rng, q) + _words(rng, 4, 120)
    qa, qlen = tlev.encode(q, L)
    ta, tlen = tlev.encode(t, L)
    np.testing.assert_array_equal(tnative.levenshtein_batch_plain(qa, qlen, ta, tlen),
                                  native.levenshtein_batch(qa, qlen, ta, tlen))
