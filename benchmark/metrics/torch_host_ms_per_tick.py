"""torch_host_ms_per_tick: host time per traced tick inside its
top-level torch and runtime calls: dispatching, launching, and the
waits inside the device-to-host copies."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.n_ticks:
        return None
    return t.torch_host_s / t.n_ticks * 1e3
