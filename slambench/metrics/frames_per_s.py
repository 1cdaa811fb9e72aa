"""frames_per_s: Frames handed to the system in the window over the window's wall time."""


def read(ctx):
    return ctx["attempted"] / ctx["window_s"] if ctx["window_s"] > 0 else None
