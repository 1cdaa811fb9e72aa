"""Per-phase host timing (port of textslam_tpu/utils/profiling.py).

Phases aggregate into a process-wide registry and can be dumped as a table.
PyTorch launches CUDA work asynchronously, so a phase measures the host time
until its last blocking call, not device time. The JAX package's
jax.profiler hook is not carried over.

Usage:
    from textslam_tpu_torch.utils.profiling import phase, report
    with phase("pose_optim"):
        ...
    print(report())
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

_STATS: Dict[str, list] = defaultdict(lambda: [0, 0.0, 0.0])  # n, total, max


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        st = _STATS[name]
        st[0] += 1
        st[1] += dt
        st[2] = max(st[2], dt)


def report(reset: bool = False) -> str:
    rows = ["phase                          n      total_s   mean_ms    max_ms"]
    for name in sorted(_STATS, key=lambda n: -_STATS[n][1]):
        n, total, mx = _STATS[name]
        rows.append(
            f"{name:<28} {n:>5} {total:>10.2f} {total / max(n, 1) * 1e3:>9.1f} {mx * 1e3:>9.1f}"
        )
    if reset:
        _STATS.clear()
    return "\n".join(rows)


def stats() -> Dict[str, dict]:
    return {
        k: {"n": v[0], "total_s": v[1], "mean_ms": v[1] / max(v[0], 1) * 1e3, "max_ms": v[2] * 1e3}
        for k, v in _STATS.items()
    }
