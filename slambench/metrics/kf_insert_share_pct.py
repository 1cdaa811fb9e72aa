"""kf_insert_share_pct: Keyframe insertion (triangulation, windowed BA, text and loop hooks) as a share of the window."""

from slambench.lib import readings

SPANS = ("tracking.insert_keyframe",)  # the spans this reader reads


def read(ctx):
    if not ctx["spans"]:
        return None
    return 100.0 * readings.total_ms(ctx, ["tracking.insert_keyframe"]) / 1e3 / ctx["window_s"]
