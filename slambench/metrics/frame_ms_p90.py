"""frame_ms_p90: 90th percentile of the per-frame latency of the system's entry."""

from slambench.lib import readings, stats

SPANS = ("system.track_monocular",)  # the spans this reader reads


def read(ctx):
    d = readings.durations_ms(ctx, "system.track_monocular")
    return stats.percentile(d, 90) if d else None
