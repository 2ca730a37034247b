"""sampler_python_ms_per_tick: the traced ticks' mean wall time less
the host time inside their top-level torch and runtime calls: the
sampler's own Python work per tick."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.n_ticks:
        return None
    return (t.tick_s - t.torch_host_s) / t.n_ticks * 1e3
