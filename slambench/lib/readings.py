"""Helpers the metric readers share: span durations and self times."""

from __future__ import annotations

from typing import Dict, Iterable, List


def durations_ms(ctx: dict, name: str) -> List[float]:
    return [1e3 * (t1 - t0) for n, _, t0, t1, _ in ctx["spans"] if n == name]


def total_ms(ctx: dict, names: Iterable[str]) -> float:
    names = set(names)
    return sum(1e3 * (t1 - t0) for n, _, t0, t1, _ in ctx["spans"] if n in names)


def self_ms(ctx: dict, name: str, children: Iterable[str]) -> List[float]:
    """Each `name` span's duration less the `children` spans inside it."""
    children = set(children)
    kids = [(t0, t1) for n, _, t0, t1, _ in ctx["spans"] if n in children]
    out = []
    for n, _, t0, t1, _ in ctx["spans"]:
        if n == name:
            inner = sum(b - a for a, b in kids if a >= t0 and b <= t1)
            out.append(1e3 * (t1 - t0 - inner))
    return out


def range_device_s(ctx: dict, names: Iterable[str]) -> float:
    """Device seconds of everything launched under the spans' profiler
    ranges, over the profiled frames."""
    trace = ctx.get("trace")
    if trace is None:
        return 0.0
    return sum(trace["ranges"].get(n, 0.0) for n in names) * 1e-6


def kept_calls(ctx: dict, names: Iterable[str]) -> List[tuple]:
    """(name, args, out) of every kept call of the spans in the profiled frames."""
    calls: Dict[str, list] = ctx.get("calls", {})
    return [(n, a, out) for n in names for _, a, _, out in calls.get(n, [])]
