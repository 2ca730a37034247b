"""tick_p95_ms: the 95th percentile of the wall times of every
``sample_once`` call in the window."""

from benchmark.stats import percentile


def read(ctx):
    p = percentile(ctx.tick_s, 95.0)
    return None if p is None else p * 1e3
