"""launches_per_frame: Device operations per profiled frame."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx["profiled_frames"]:
        return None
    a, b = tr["window_us"]
    return sum(1 for _, s, e in tr["ops"] if s >= a and e <= b) / ctx["profiled_frames"]
