"""sampler_roofline_pct: Least time of the grouped sampler calls of the profiled frames over their device time."""

from slambench.lib import readings, roofline

SPANS = ("ops.grouped_bilinear_stack",)  # the spans this reader reads


def read(ctx):
    calls = readings.kept_calls(ctx, ["ops.grouped_bilinear_stack"])
    dev = readings.range_device_s(ctx, ["ops.grouped_bilinear_stack"])
    if not calls or dev <= 0:
        return None
    least = 0.0
    for _, args, out in calls:
        imgs, group_k, uv = args[:3]
        least += roofline.bound_s(*roofline.sampler_work(imgs.shape, group_k, uv, out[1]),
                                  ctx["kind"])
    return 100.0 * least / dev
