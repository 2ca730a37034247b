"""Offline fleet-telemetry replay: a what-if over a recorded incident.

"What would CoDel and the shrink damper have done across the whole
fleet during yesterday's load burst?" The recorded per-pool signals
become a [T, P] window, and ``fleet_scan`` replays the framework's
control laws (128-tap FIR shrink damping, CoDel shedding, backoff
reproduction; the code the live sampler runs) for every pool and every
tick in one call. That call steps the window tick by tick, one
``fleet_step`` (one FIR kernel launch on the card) per tick.

    python -m cueball_tpu_torch.examples.telemetry_replay [--device cpu]

The sizes and the seed are those of the JAX package's example: 64 pools,
200 ticks (one per 100 ms, a 20 s incident window), seed 42.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .._device import resolve_device
from ..parallel.telemetry import (FleetInputs, fleet_init, fleet_inputs,
                                  fleet_scan)

P = 64     # pools across the fleet
T = 200    # recorded ticks (one per 100 ms -> a 20 s incident window)


def synth_window(device) -> FleetInputs:
    """Synthesize the incident: steady load, then a burst that drives
    claim sojourns past the 200 ms CoDel target on half the fleet."""
    rng = np.random.default_rng(42)
    t = np.arange(T, dtype=np.float32)[:, None]        # [T, 1]
    base = 3.0 + rng.normal(0, 0.3, size=(T, P)).astype(np.float32)
    burst = np.where((t > 80) & (t < 140), 6.0, 0.0)   # the incident
    hot = (np.arange(P) % 2 == 0).astype(np.float32)   # half the fleet
    samples = np.clip(base + burst * hot, 0.0, None)

    sojourns = 20.0 + 30.0 * samples   # ~110 ms calm, ~290 ms burst
    ticks = [fleet_inputs(
        P, device=device,
        samples=samples[i],
        sojourns=sojourns[i].astype(np.float32),
        target_delay=np.full(P, 200.0, np.float32),
        spares=np.full(P, 2.0, np.float32),
        maximum=np.full(P, 16.0, np.float32),
        active=np.ones(P, bool),
        now_ms=np.float32(100.0 * (i + 1))) for i in range(T)]
    return FleetInputs(*(torch.stack(col) for col in zip(*ticks)))


def main(device=None) -> dict:
    """Replay the incident on ``device`` (default CUDA); prints the
    findings and returns them, with the replay itself as numpy arrays:
    every per-pool output [T, P] under ``outs``, every fleet aggregate
    [T] under ``fleets``, and the window's ``samples`` and ``spares``
    [T, P], so a caller can hold two replays row by row."""
    dev = resolve_device(device)
    window = synth_window(dev)
    _, outs, fleets = fleet_scan(fleet_init(P, device=dev), window)
    outs = {k: v.cpu().numpy() for k, v in outs.items()}
    fleets = {k: v.cpu().numpy() for k, v in fleets.items()}

    drops = outs['drop']                               # [T, P] bool
    overload = fleets['overload_frac']                 # [T]
    peak_tick = int(np.argmax(overload))
    clamped = int(outs['clamped'].sum())

    print('replayed %d ticks x %d pools with one fleet_scan call '
          '(%d steps on %s)' % (T, P, T, dev))
    print('mean fleet load: %.2f' % float(fleets['mean_load'].mean()))
    print('overload fraction peaked at %.2f (tick %d)' % (
        float(overload[peak_tick]), peak_tick))
    print('codel would have shed on %d pool-ticks' % int(drops.sum()))
    print('shrink damper clamped %d rebalance targets' % clamped)
    if not 80 < peak_tick < 160:
        raise RuntimeError('the overload peak (tick %d) is outside the '
                           'burst' % peak_tick)
    if drops[:70].sum():
        raise RuntimeError('CoDel shed before the burst')
    return {'peak_tick': peak_tick,
            'peak_overload': float(overload[peak_tick]),
            'drops': int(drops.sum()), 'clamped': clamped,
            'outs': outs, 'fleets': fleets,
            'samples': window.samples.cpu().numpy(),
            'spares': window.spares.cpu().numpy()}


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default=None,
                        help='torch device (default: the CUDA card)')
    main(parser.parse_args().device)
