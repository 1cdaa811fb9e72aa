"""frame_build_ms: Frame build (keypoints, descriptors, pyramid) per window frame."""

from slambench.lib import readings

SPANS = ("frame.build_frame",)  # the spans this reader reads


def read(ctx):
    d = readings.durations_ms(ctx, "frame.build_frame")
    return sum(d) / ctx["attempted"] if d else None
