"""tick_ms: mean wall time of every ``sample_once`` call in the window,
on the host clock; each call ends in its device-to-host copies."""

from benchmark.stats import mean


def read(ctx):
    m = mean(ctx.tick_s)
    return None if m is None else m * 1e3
