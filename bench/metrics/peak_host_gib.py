"""The highest resident set size of the process that the benchmark's
thread sampled (every ~10 ms), in GiB.  Out of core, the sampling covers
the window's first whole pass: a fixed amount of work, whatever the
host's speed."""

GIB = float(1 << 30)


def read(ctx):
    peak = ctx.get("peak_host_bytes")
    return None if peak is None else peak / GIB
