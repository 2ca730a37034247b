"""device_busy_ms_per_tick: the union of the device's busy intervals
inside the traced ticks, per tick."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.n_ticks or t.busy_in_ticks_s <= 0.0:
        return None
    return t.busy_in_ticks_s / t.n_ticks * 1e3
