"""The port's native host routines (textslam_tpu_torch/native.py,
csrc/native.cpp) held against the JAX package's native module and against
their plain versions: exact integer equality throughout (covisibility
counts and edit distances are integers, and every version computes them
exactly).

Covisibility at K = 1, 2, 5, 64 and 200 keyframes with up to 32,768 points,
on incidences drawn from a seed at 3% density (phase 9(c)'s, about 1,000
points a keyframe) and at 50%; Levenshtein on tests/test_native.py's words
and on random ASCII and CJK strings padded to L = 16..256. Also: a failed
build raises (no fallback), concurrent calls from Python threads agree,
and the module loads no jax.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from textslam_tpu import native as jnative
from textslam_tpu_torch import native
from textslam_tpu_torch.ops import cuda_lib
from textslam_tpu_torch.ops import levenshtein as tlev

ALPHA = list("ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-#") + list("咖啡店出口酒店東京駅")


@pytest.mark.parametrize("K,P,density", [(1, 512, 0.03), (2, 512, 0.5), (5, 32768, 0.03),
                                         (64, 4096, 0.5), (64, 32768, 0.03),
                                         (200, 32768, 0.03), (200, 777, 0.5)])
def test_covis_product_exact(K, P, density):
    inc = np.random.default_rng(K * 7919 + P).random((K, P)) < density
    got = native.covis_product(inc)
    assert got.dtype == np.int32 and got.shape == (K, K)
    np.testing.assert_array_equal(got, native.covis_product_plain(inc))
    np.testing.assert_array_equal(got, jnative.covis_product(inc))
    assert (np.diag(got) == 0).all() and (got == got.T).all()


def test_covis_product_takes_any_incidence_layout():
    """A strided or non-bool incidence gives the product of its truth values."""
    inc = np.random.default_rng(3).integers(0, 3, (9, 300)).astype(np.int64)
    want = native.covis_product_plain(inc != 0)
    np.testing.assert_array_equal(native.covis_product(inc != 0), want)
    np.testing.assert_array_equal(native.covis_product(inc.astype(bool)[:, ::1]), want)
    wide = np.zeros((9, 600), bool)
    wide[:, ::2] = inc != 0
    np.testing.assert_array_equal(native.covis_product(wide[:, ::2]), want)


def test_covis_product_empty():
    np.testing.assert_array_equal(native.covis_product(np.zeros((0, 64), bool)),
                                  np.zeros((0, 0), np.int32))
    np.testing.assert_array_equal(native.covis_product(np.ones((3, 0), bool)),
                                  np.zeros((3, 3), np.int32))


def _words(rng, n, max_len):
    out = ["", "EXIT", "咖啡店", "HOTEL-出口"]
    while len(out) < n:
        k = int(rng.integers(1, max_len + 1))
        out.append("".join(rng.choice(ALPHA, k)))
    return [w[:max_len] for w in out]


def _check_lev(qa, qlen, ta, tlen):
    got = native.levenshtein_batch(qa, qlen, ta, tlen)
    assert got.dtype == np.int32 and got.shape == (len(qa), len(ta))
    np.testing.assert_array_equal(got, native.levenshtein_batch_plain(qa, qlen, ta, tlen))
    np.testing.assert_array_equal(got, jnative.levenshtein_batch(qa, qlen, ta, tlen))
    return got


def test_levenshtein_test_native_words():
    """tests/test_native.py's words (L = 12), with known distances."""
    qa, qlen = tlev.encode(["kitten", "flaw", "saturday", "", "你好世界"], 12)
    ta, tlen = tlev.encode(["sitting", "lawn", "sunday", "你好"], 12)
    got = _check_lev(qa, qlen, ta, tlen)
    assert got[0, 0] == 3 and got[1, 1] == 2 and got[2, 2] == 3
    assert (got[3] == tlen).all() and got[4, 3] == 2


@pytest.mark.parametrize("L,nq,nt", [(16, 9, 11), (64, 6, 7), (128, 4, 5), (256, 3, 4)])
def test_levenshtein_random_exact(L, nq, nt):
    """Random ASCII + CJK strings up to L, with a full-length pair and
    near-copies (edits) of the queries among the targets."""
    rng = np.random.default_rng(L)
    q = _words(rng, nq, L)
    q[-1] = "".join(rng.choice(ALPHA, L))
    t = [w[: max(0, len(w) - 2)] + "X" for w in q[: nt // 2]] + _words(rng, nt - nt // 2, L)
    qa, qlen = tlev.encode(q, L)
    ta, tlen = tlev.encode(t, L)
    got = _check_lev(qa, qlen, ta, tlen)
    assert got[0, 0] == 1  # "" vs "X"


def test_levenshtein_rejects_bad_lengths():
    a, alen = tlev.encode(["ABC"], 4)
    with pytest.raises(ValueError, match="lengths"):
        native.levenshtein_batch(a, alen + 2, a, alen)
    b, blen = tlev.encode(["ABC"], 8)
    with pytest.raises(ValueError, match="padded"):
        native.levenshtein_batch(a, alen, b, blen)


def test_concurrent_calls_agree():
    """ctypes releases the interpreter lock for the call: eight Python
    threads calling both routines at once get the single-threaded answers."""
    rng = np.random.default_rng(1)
    inc = rng.random((40, 5000)) < 0.1
    qa, qlen = tlev.encode(_words(rng, 12, 48), 64)
    want_c = native.covis_product(inc)
    want_l = native.levenshtein_batch(qa, qlen, qa, qlen)
    errors = []

    def work():
        try:
            for _ in range(10):
                np.testing.assert_array_equal(native.covis_product(inc), want_c)
                np.testing.assert_array_equal(native.levenshtein_batch(qa, qlen, qa, qlen),
                                              want_l)
        except AssertionError as e:  # pragma: no cover - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[0]


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails makes the first call raise, with the compiler's
    output: there is no fallback to the plain versions."""
    fake = tmp_path / "broken-c++"
    fake.write_text("#!/bin/sh\necho 'broken compiler' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_lib, "_LIBS", {})
    with pytest.raises(RuntimeError, match="broken compiler"):
        native.covis_product(np.ones((3, 8), bool))
    with pytest.raises(RuntimeError, match="broken compiler"):
        native.levenshtein_batch(*tlev.encode(["A"], 4), *tlev.encode(["B"], 4))
    assert not [f for f in os.listdir(tmp_path / "build") if f.endswith(".so")]


def test_native_loads_no_jax():
    code = ("import sys, numpy as np; import textslam_tpu_torch.native as n; "
            "n.covis_product(np.ones((2, 3), bool)); "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'textslam_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
