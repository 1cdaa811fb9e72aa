"""frame_ms_p50: Median per-frame latency of the system's entry, synchronised, over the window."""

from slambench.lib import readings, stats

SPANS = ("system.track_monocular",)  # the spans this reader reads


def read(ctx):
    d = readings.durations_ms(ctx, "system.track_monocular")
    return stats.percentile(d, 50) if d else None
