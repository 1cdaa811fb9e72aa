"""text_maturation_ms: Text maturation and new-text tracks per window frame."""

from slambench.lib import readings

SPANS = ("text.dispatch_immature", "text.track_new_text")  # the spans this reader reads


def read(ctx):
    d = readings.total_ms(ctx, ["text.dispatch_immature", "text.track_new_text"])
    n = len(readings.durations_ms(ctx, "text.dispatch_immature"))
    return d / ctx["attempted"] if n else None
