"""track_ms: The tracker per window frame, less keyframe insertion and text maturation."""

from slambench.lib import readings

SPANS = ("tracking.process", "tracking.insert_keyframe", "text.dispatch_immature",
         "text.track_new_text")  # the spans this reader reads


def read(ctx):
    d = readings.self_ms(ctx, "tracking.process", ("tracking.insert_keyframe",
                                                   "text.dispatch_immature", "text.track_new_text"))
    return sum(d) / ctx["attempted"] if d else None
