"""host_rss_mb: Peak resident set of the process at the end (MB of 2**20 bytes)."""


def read(ctx):
    return ctx["rss_bytes"] / 2 ** 20
