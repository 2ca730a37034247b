"""The traced run's reading of a ``torch.profiler`` trace: which device
work and which host work fell inside the traced ticks.

The benchmark marks each traced tick with a ``record_function`` range
named :data:`TICK`. From the trace it takes:

- the ticks' own intervals (those ranges);
- the device's busy time, as the *union* of its kernel, copy and set
  intervals, so that a copy that overlaps a kernel is counted once;
- the device operations that start inside a tick (launches);
- the host time inside the top-level torch and runtime calls of each
  tick: calls made by the tick's own Python code and nested in no
  other traced call;
- the device's idle time inside the ticks, split by what the host was
  doing meanwhile: each top-level call it was in, and ``host python``
  for the rest.
"""

from __future__ import annotations

import bisect
import collections

from . import stats

TICK = 'perfbench.tick'
TOP = 10


def events_of(prof) -> list:
    """(name, kind, start_us, end_us, thread) for every event of a
    finished ``torch.profiler.profile``; kind is ``tick``, ``cpu`` or
    ``device``. Device-side copies of user ranges are dropped."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.events():
        if getattr(ev, 'is_async', False):
            continue
        name = ev.name
        annotation = bool(getattr(ev, 'is_user_annotation', False))
        start, end = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CPU:
            kind = 'tick' if name == TICK else 'cpu'
        elif name == TICK or annotation:
            continue
        else:
            kind = 'device'
        out.append((name, kind, float(start), float(end), ev.thread))
    return out


class TraceSummary:
    """The numbers the per-layer readers take from one traced window.
    Times are seconds."""

    def __init__(self, events: list, window_s: float):
        ticks = sorted((s, e) for _, k, s, e, _ in events if k == 'tick')
        threads = {t for _, k, _, _, t in events if k == 'tick'}
        device = [(n, s, e) for n, k, s, e, _ in events if k == 'device']
        cpu = sorted(((s, -e, n) for n, k, s, e, t in events
                      if k == 'cpu' and t in threads))
        self.n_ticks = len(ticks)
        self.window_s = window_s
        self.tick_s = stats.length(ticks) / 1e6
        busy_all = stats.union((s, e) for _, s, e in device)
        self.busy_s = stats.length(busy_all) / 1e6

        top, end = [], float('-inf')
        for s, neg_e, n in cpu:
            if s >= end:
                top.append((n, s, -neg_e))
                end = -neg_e
        inside = [(n, s, e) for n, s, e in top
                  if any(ts <= s < te for ts, te in ticks)]
        self.torch_host_s = sum(e - s for _, s, e in inside) / 1e6

        starts = [s for _, s, _ in inside]
        busy_ticks, gaps = [], collections.Counter()
        launches = 0
        ops = collections.Counter()
        for ts, te in ticks:
            mine = [(n, s, e) for n, s, e in device if ts <= s < te]
            launches += len(mine)
            for n, s, e in mine:
                ops[n] += (e - s) / 1e6
            busy = stats.clip(busy_all, ts, te)
            busy_ticks += busy
            edge = ts
            for s, e in busy + [(te, te)]:
                if s > edge:
                    _split(gaps, inside, starts, edge, s)
                edge = max(edge, e)
        self.launches = launches
        self.busy_in_ticks_s = stats.length(busy_ticks) / 1e6
        self.device_ops = [[n, v] for n, v in ops.most_common(TOP)]
        self.idle_gaps = [[n, v] for n, v in gaps.most_common(TOP)]


def _split(gaps, top: list, starts: list, a: float, b: float) -> None:
    """Add the idle gap ``[a, b]`` to ``gaps`` by the top-level calls
    that overlap it (they do not overlap each other), the rest to
    ``host python``."""
    covered = 0.0
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    while i < len(top) and top[i][1] < b:
        name, s, e = top[i]
        part = min(e, b) - max(s, a)
        if part > 0:
            gaps[name] += part / 1e6
            covered += part
        i += 1
    gaps['host python'] += (b - a - covered) / 1e6
