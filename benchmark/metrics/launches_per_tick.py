"""launches_per_tick: device kernels, copies and sets that start inside
the traced ticks, per tick."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.n_ticks or not t.launches:
        return None
    return t.launches / t.n_ticks
