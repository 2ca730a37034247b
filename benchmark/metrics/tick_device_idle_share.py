"""tick_device_idle_share: the share of the traced ticks' wall time in
which the device ran nothing: 1 - the union of its busy intervals
inside the ticks over the ticks' summed spans, in percent."""


def read(ctx):
    t = ctx.trace
    if t is None or t.tick_s <= 0.0 or t.busy_in_ticks_s <= 0.0:
        return None
    return 100.0 * (1.0 - t.busy_in_ticks_s / t.tick_s)
