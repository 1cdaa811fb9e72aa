"""setup_s: Process start to the first timed frame."""


def read(ctx):
    return ctx["setup_s"]
