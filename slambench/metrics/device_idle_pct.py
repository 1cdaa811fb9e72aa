"""device_idle_pct: 100 less the union of device operation intervals over the profiled frames' wall time."""

from slambench.lib import trace

# the spans the breakdown's idle gaps are named by
SPANS = ("text.fused_frame_chain", "tracking.process")


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    a, b = tr["window_us"]
    return 100.0 * (1.0 - trace.busy_us(tr) / (b - a))
