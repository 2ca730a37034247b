"""Where the live telemetry tick's device time goes, on the card.

    python -m cueball_tpu_torch.profile_live

Runs the live step (``make_live_step``) at 1,048,576 pools, 128 taps:
10 warm-up ticks, then 20 ticks under ``torch.profiler`` with CUDA
activity. Prints the device time of every kernel and copy by name (sum
over the profiled ticks, per tick, share of the device-busy time), the
tick time by CUDA events, and the device's busy and idle shares of it.
The tick inputs are made before the profiled window, so it holds only
the step. Exits 1 without a CUDA device, or if the trace holds no
device events.
"""

from __future__ import annotations

import collections
import json
import sys

import numpy as np
import torch

POOLS = 1 << 20
WARMUP, TICKS = 10, 20


def main() -> int:
    if not torch.cuda.is_available():
        print('profile_live: no CUDA device', file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .entry import example_inputs, tick_inputs
    from .parallel.telemetry import make_live_step

    rng = np.random.default_rng(5)
    state, base = example_inputs(POOLS, seed=5)
    ticks = [tick_inputs(base, rng, k) for k in range(WARMUP + TICKS)]
    live = make_live_step()
    for inp in ticks[:WARMUP]:
        state, _, _ = live(state, inp)
    torch.cuda.synchronize()

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for inp in ticks[WARMUP:]:
            state, _, _ = live(state, inp)
        end.record()
        torch.cuda.synchronize()
    wall_us = start.elapsed_time(end) * 1e3

    by_name = collections.defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            rec = by_name[ev.name]
            rec[0] += ev.time_range.elapsed_us()
            rec[1] += 1
    busy_us = sum(v[0] for v in by_name.values())
    if busy_us <= 0:
        print('profile_live: the trace holds no device events',
              file=sys.stderr)
        return 1

    print('%10s %8s %7s  %s' % ('us/tick', 'calls', 'share', 'kernel'))
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (us, calls) in rows:
        print('%10.2f %8.2f %6.1f%%  %s' % (us / TICKS, calls / TICKS,
                                           100.0 * us / busy_us, name[:110]))
    summary = {
        'pools': POOLS, 'ticks': TICKS,
        'tick_ms': wall_us / TICKS / 1e3,
        'device_busy_ms_per_tick': busy_us / TICKS / 1e3,
        'device_idle_share': max(0.0, 1.0 - busy_us / wall_us),
        'device_launches_per_tick': sum(v[1] for v in by_name.values())
        / TICKS,
        'kind': torch.cuda.get_device_name(0),
    }
    print(json.dumps(summary))
    return 0


if __name__ == '__main__':
    sys.exit(main())
