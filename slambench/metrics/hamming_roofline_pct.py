"""hamming_roofline_pct: Least time of the Hamming calls of the profiled frames over their device time."""

from slambench.lib import readings, roofline

SPANS = ("ops.hamming_matrix", "ops.hamming_matrix_min")  # the spans this reader reads


def read(ctx):
    calls = readings.kept_calls(ctx, ["ops.hamming_matrix", "ops.hamming_matrix_min"])
    dev = readings.range_device_s(ctx, ["ops.hamming_matrix", "ops.hamming_matrix_min"])
    if not calls or dev <= 0:
        return None
    least = 0.0
    for name, args, _ in calls:
        alt = name.endswith("_min")
        n1, n2 = args[0].shape[0], args[-1].shape[0]
        least += roofline.bound_s(*roofline.hamming_work(n1, n2, alt), ctx["kind"])
    return 100.0 * least / dev
