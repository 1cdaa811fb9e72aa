"""Spans and call records from the benchmark's own side.

A span wraps one name where its caller looks it up: a module attribute
(`{"root": "module", "path": "textslam_tpu_torch.system", "attr":
"build_frame"}`) or an attribute of an object reached from the system under
test (`{"root": "slam", "path": "tracker.text_frontend", "attr":
"dispatch_immature"}`). In a traced run a span synchronises the device at
both ends (`"sync": false` leaves that out) and times the call on the host
clock; while the profiler runs it also opens a profiler range
`span:<name>`, so the device time of everything the call launched is
attributed to it, and with `"keep_calls": true` it keeps the call's
arguments and result for the readers.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch


class Recorder:
    """What the spans of one run saw. `frame` is the window frame being
    handed over (None in set-up)."""

    def __init__(self, sync: bool):
        self.sync = sync and torch.cuda.is_available()
        self.tracing = False  # spans record only inside the traced window
        self.profiling = False  # profiler ranges and kept calls
        self.frame: Optional[int] = None
        self.spans: List[tuple] = []  # (name, frame, t0, t1, depth)
        self.calls: Dict[str, list] = defaultdict(list)  # name -> [(frame, args, kwargs, out)]
        self._depth = 0

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = True):
        """Record `name` around the block (a harness step)."""
        if not self.tracing:
            yield
            return
        do_sync = self.sync and sync
        if do_sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        self._depth += 1
        rng = (torch.profiler.record_function(f"span:{name}") if self.profiling
               else contextlib.nullcontext())
        try:
            with rng:
                yield
        finally:
            self._depth -= 1
            if do_sync:
                torch.cuda.synchronize()
            self.spans.append((name, self.frame, t0, time.perf_counter(), self._depth))

    def wrap(self, fn: Callable, name: str, sync: bool = True, keep: bool = False) -> Callable:
        rec = self

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not rec.tracing:
                return fn(*args, **kwargs)
            with rec.span(name, sync=sync):
                out = fn(*args, **kwargs)
            if keep and rec.profiling:
                rec.calls[name].append((rec.frame, args, kwargs, out))
            return out

        return spanned


def resolve(spec: dict, slam):
    """(owner, attr) that a span or a probe names, or None when the owner
    does not exist in this configuration (text off: no text frontend)."""
    if spec["root"] == "module":
        owner = importlib.import_module(spec["path"])
    elif spec["root"] == "slam":
        owner = slam
        for part in filter(None, spec["path"].split(".")):
            owner = getattr(owner, part, None)
            if owner is None:
                return None
    else:
        raise ValueError(f"span root {spec['root']!r}: want 'module' or 'slam'")
    if not hasattr(owner, spec["attr"]):
        raise AttributeError(f"span {spec.get('name')}: {spec['path']} has no {spec['attr']}")
    return owner, spec["attr"]


def install(specs: List[dict], slam, rec: Recorder) -> Callable[[], None]:
    """Wrap every span's name; returns the function that puts them back."""
    undo = []
    for s in specs:
        target = resolve(s, slam)
        if target is None:
            continue
        owner, attr = target
        orig = getattr(owner, attr)
        setattr(owner, attr, rec.wrap(orig, s["name"], sync=s.get("sync", True),
                                      keep=s.get("keep_calls", False)))
        undo.append((owner, attr, orig))

    def restore():
        for owner, attr, orig in reversed(undo):
            setattr(owner, attr, orig)

    return restore


def patch(owner, attr: str, make: Callable[[Callable], Callable]) -> Callable[[], None]:
    """Replace owner.attr by make(original); returns the undo."""
    orig = getattr(owner, attr)
    setattr(owner, attr, functools.wraps(orig)(make(orig)))
    return lambda: setattr(owner, attr, orig)
