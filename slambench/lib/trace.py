"""What the profiler saw over the profiled frames of a traced window: the
device operations with their intervals, the device time of each span's
profiler range, the busy share as the union of operation intervals, and the
idle gaps by the span that was open on the host."""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

from . import stats

WINDOW_RANGE = "bench:profiled"


def reduce(prof) -> dict:
    """{window_us: (start, end), ops: [(name, start, end)], ranges:
    {span: device us}, span_intervals: [(name, start, end)]}, times in
    microseconds on the profiler's clock. `ops` are the device operations
    (kernels, copies, sets); the device side of a span's profiler range
    (its annotation on the device's timeline) is not one: a span's device
    time is that of the operations inside its annotation."""
    cuda = torch.autograd.DeviceType.CUDA
    ops, notes, span_iv, window = [], [], [], None
    for e in prof.events():
        tr = e.time_range
        ours = e.name.startswith("span:") or e.name == WINDOW_RANGE
        if e.device_type == cuda:
            if ours:
                if e.name != WINDOW_RANGE:
                    notes.append((e.name[5:], float(tr.start), float(tr.end)))
            elif tr.end > tr.start:
                ops.append((e.name, float(tr.start), float(tr.end)))
        elif e.name == WINDOW_RANGE:
            window = (float(tr.start), float(tr.end))
        elif ours:
            span_iv.append((e.name[5:], float(tr.start), float(tr.end)))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_RANGE} range")
    ops.sort(key=lambda o: o[1])
    starts = [s for _, s, _ in ops]
    ranges = defaultdict(float)
    for name, a, b in notes:
        j = bisect.bisect_left(starts, a)
        while j < len(ops) and ops[j][1] < b:
            ranges[name] += min(ops[j][2], b) - ops[j][1]
            j += 1
    return {"window_us": window, "ops": ops, "ranges": dict(ranges), "span_intervals": span_iv}


def busy_us(red: dict) -> float:
    """Union of the device operations' intervals inside the window."""
    a, b = red["window_us"]
    return stats.union_length((max(s, a), min(e, b)) for _, s, e in red["ops"] if e > a and s < b)


NAME_CHARS = 160  # a kernel's name is cut to this many characters in the breakdown


def breakdown(red: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by the
    innermost span open on the host at each gap's middle ("harness" where
    none was), each [name, seconds], longest first."""
    by_op = defaultdict(float)
    for name, s, e in red["ops"]:
        by_op[name[:NAME_CHARS]] += (e - s) * 1e-6
    a, b = red["window_us"]
    # sweep: span starts and ends, then each gap's middle; spans on the
    # host thread nest, so the innermost open span is the last one opened
    marks = []
    for i, (n, s, e) in enumerate(red["span_intervals"]):
        marks.append((s, 0, i))
        marks.append((e, 2, i))
    for g0, g1 in stats.gaps(((s, e) for _, s, e in red["ops"]), a, b):
        marks.append((0.5 * (g0 + g1), 1, g1 - g0))
    idle = defaultdict(float)
    open_spans = []
    for t, kind, x in sorted(marks):
        if kind == 0:
            open_spans.append(x)
        elif kind == 2:
            open_spans.remove(x)
        else:
            name = red["span_intervals"][open_spans[-1]][0] if open_spans else "harness"
            idle[name] += x * 1e-6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(idle)}
