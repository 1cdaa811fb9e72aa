"""Native host routines, port of textslam_tpu/native/.

Two routines of the host runtime, in C++ (csrc/native.cpp, built with the
host C++ compiler at first use through ops/cuda_lib.py and called through
ctypes, which releases the interpreter lock for the call), each threaded
over rows:

- `levenshtein_batch`: all-pairs edit distance of padded codepoint rows of
  any length. The loop closer takes it when a call's strings are longer
  than the device DP's cap (`LoopConfig.lev_device_max_len`).
- `covis_product`: the shared-observation counts of a keyframe incidence,
  for the covisibility rebuilds without a mesh (`SlamMap._covis_product`).

Beside each, its plain version (`levenshtein_batch_plain`, the JAX
package's Python DP; `covis_product_plain`, the numpy int32 product), which
the tests hold the routines to; nothing on the path calls them. There is no
fallback: a failed build raises. The JAX module's file prefetcher is the
read-ahead thread of io/dataset.py here.
"""

from __future__ import annotations

import numpy as np

from .ops import cuda_lib


def _lib():
    return cuda_lib.load("native")


def _check_codes(a: np.ndarray, alen: np.ndarray, name: str):
    a = np.ascontiguousarray(a, np.int32)
    alen = np.ascontiguousarray(alen, np.int32)
    if a.ndim != 2 or alen.shape != (a.shape[0],):
        raise ValueError(f"{name}: codes must be [N, L] with lengths [N], got {a.shape} and "
                         f"{alen.shape}")
    if alen.size and (alen.min() < 0 or alen.max() > a.shape[1]):
        raise ValueError(f"{name}: lengths must lie in [0, {a.shape[1]}]")
    return a, alen


def levenshtein_batch(a: np.ndarray, alen: np.ndarray, b: np.ndarray,
                      blen: np.ndarray) -> np.ndarray:
    """All-pairs edit distance: a [Q, L], b [T, L] int32 codepoints padded to
    one length, with their lengths -> [Q, T] int32."""
    a, alen = _check_codes(a, alen, "a")
    b, blen = _check_codes(b, blen, "b")
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"a and b are padded to {a.shape[1]} and {b.shape[1]}")
    Q, L = a.shape
    T = b.shape[0]
    out = np.empty((Q, T), np.int32)
    _lib().levenshtein_batch(a.ctypes.data, alen.ctypes.data, b.ctypes.data, blen.ctypes.data,
                             Q, T, L, out.ctypes.data)
    return out


def levenshtein_batch_plain(a: np.ndarray, alen: np.ndarray, b: np.ndarray,
                            blen: np.ndarray) -> np.ndarray:
    """The plain version of levenshtein_batch: the JAX package's pure-Python
    DP."""
    Q, T = a.shape[0], b.shape[0]
    out = np.zeros((Q, T), np.int32)
    for q in range(Q):
        aw = a[q, : alen[q]]
        for t in range(T):
            bw = b[t, : blen[t]]
            dp = list(range(len(bw) + 1))
            for i, ca in enumerate(aw):
                new = [i + 1]
                for j, cb in enumerate(bw):
                    new.append(min(dp[j + 1] + 1, new[-1] + 1, dp[j] + (ca != cb)))
                dp = new
            out[q, t] = dp[-1]
    return out


def covis_product(inc: np.ndarray) -> np.ndarray:
    """Symmetric shared-observation counts inc @ inc.T with a zero diagonal,
    int32, from a [K, P] bool incidence."""
    if inc.ndim != 2:
        raise ValueError(f"incidence must be [K, P], got {inc.shape}")
    inc = np.ascontiguousarray(inc, bool).view(np.uint8)
    K, P = inc.shape
    out = np.empty((K, K), np.int32)
    _lib().covis_product(inc.ctypes.data, K, P, out.ctypes.data)
    return out


def covis_product_plain(inc: np.ndarray) -> np.ndarray:
    """The plain version of covis_product: the numpy int32 product."""
    inc_i = inc.astype(np.int32)
    M = inc_i @ inc_i.T
    np.fill_diagonal(M, 0)
    return M
