"""tick_device_roofline: the least time the tick's device work could
take at the card's peak HBM bandwidth (the bytes that
``benchmark.roofline.tick_bytes`` counts from the shapes), over the
device's busy time per traced tick, in percent. The ring of 65,536 x
128 float32 fits in the H100's 50 MB L2, so this is a lower estimate
of the share of what the memory system can give."""

from benchmark.roofline import PEAK_BYTES_PER_S, tick_bytes


def read(ctx):
    t = ctx.trace
    peak = PEAK_BYTES_PER_S.get(ctx.device_kind)
    if t is None or peak is None or not t.n_ticks or \
            t.busy_in_ticks_s <= 0.0:
        return None
    cfg = ctx.config
    need = tick_bytes(int(cfg['capacity']), int(cfg['taps']),
                      int(ctx.traffic['backends']) + 1,
                      bool(cfg['control']), bool(cfg['health']))
    return 100.0 * (need / peak) / (t.busy_in_ticks_s / t.n_ticks)
