"""Where the fleet runtime's device time goes, on the card.

    python -m cueball_tpu_torch.profile_live

Profiles four steps under ``torch.profiler`` with CUDA activity, each
after warm-up ticks, with its inputs made before the profiled window:

- ``live``: the live telemetry step (``make_live_step``) at 1,048,576
  pools, 128 taps, 20 ticks;
- ``control``: the control step at 1,048,576 pools, 20 steps;
- ``health``: the health step at 102,400 backends, 20 steps;
- ``sampler``: ``FleetSampler.sample_once`` with control and health on
  over ``entry.SamplerWorkload`` at 65,536 pools (``chip_smoke.py``'s
  phase 9 workload: CoDel queues, waiting claims, 1% of pools changing
  load and 512 attributed claims per tick), 20 ticks;
- ``sharded_live``, ``sharded_control``, ``sharded_health`` and
  ``mesh_sampler``: the same four over a 4-shard ``Mesh`` whose shards
  all live on ``cuda:0`` (``make_live_step(mesh)``,
  ``make_control_step(mesh)``, ``make_health_step(mesh)`` and
  ``FleetSampler({'mesh': mesh})``, ``chip_smoke.py`` phases 11-12);
- ``router_sample``, ``router_control`` and ``router_health``: the
  fleet passes of ``shard.FleetRuntime`` over an
  ``entry.ShardedWorkload`` of 4 shard loop threads x 16,384 pools
  (``chip_smoke.py`` phase 13's workload, control and health on), 20
  passes each after ``advance()``, the three sections over one
  workload in turn.

For each it prints the device time of every kernel and copy by name
(per tick, launches per tick, share of the device-busy time), then one
JSON line per step: the tick time by CUDA events, the device's busy
time, idle share and launches per tick. Exits 1 without a CUDA device,
or if a trace holds no device events.
"""

from __future__ import annotations

import asyncio
import collections
import json
import sys

import numpy as np
import torch

POOLS = 1 << 20
BACKENDS = 102_400
SAMPLER_POOLS = 1 << 16
WARMUP, TICKS = 10, 20
SHARDS = 4
TOP = 15


class NoDeviceEvents(Exception):
    pass


def _profile(name: str, ticks: list) -> dict:
    """Profile ``tick()`` for each callable of ``ticks``; returns the
    step's summary after printing its kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for tick in ticks:
            tick()
        end.record()
        torch.cuda.synchronize()
    wall_us = start.elapsed_time(end) * 1e3
    n = len(ticks)

    by_name = collections.defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            rec = by_name[ev.name]
            rec[0] += ev.time_range.elapsed_us()
            rec[1] += 1
    busy_us = sum(v[0] for v in by_name.values())
    if busy_us <= 0:
        raise NoDeviceEvents('the %s trace holds no device events' % name)

    print('== %s' % name)
    print('%10s %8s %7s  %s' % ('us/tick', 'calls', 'share', 'kernel'))
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for kname, (us, calls) in rows[:TOP]:
        print('%10.2f %8.2f %6.1f%%  %s' % (us / n, calls / n,
                                           100.0 * us / busy_us, kname[:110]))
    if len(rows) > TOP:
        rest = rows[TOP:]
        print('%10.2f %8.2f %6.1f%%  (%d more kernels)' % (
            sum(v[0] for _, v in rest) / n, sum(v[1] for _, v in rest) / n,
            100.0 * sum(v[0] for _, v in rest) / busy_us, len(rest)))
    return {
        'step': name, 'ticks': n,
        'tick_ms': wall_us / n / 1e3,
        'device_busy_ms_per_tick': busy_us / n / 1e3,
        'device_idle_share': max(0.0, 1.0 - busy_us / wall_us),
        'device_launches_per_tick': sum(v[1] for v in by_name.values()) / n,
        'kind': torch.cuda.get_device_name(0),
    }


def _mesh():
    from .parallel.mesh import Mesh
    return Mesh([torch.device('cuda', 0)] * SHARDS, ('pools',))


def _live(mesh=None):
    from .entry import example_inputs, tick_inputs
    from .parallel.telemetry import make_live_step, shard_inputs, shard_state

    rng = np.random.default_rng(5)
    st, base = example_inputs(POOLS, seed=5)
    inputs = [tick_inputs(base, rng, k) for k in range(WARMUP + TICKS)]
    live = make_live_step(mesh)
    if mesh is not None:
        st = shard_state(st, mesh)
        inputs = [shard_inputs(inp, mesh) for inp in inputs]
    state = [st]

    def tick(inp):
        state[0] = live(state[0], inp)[0]
    for inp in inputs[:WARMUP]:
        tick(inp)
    return [lambda inp=inp: tick(inp) for inp in inputs[WARMUP:]]


def _control(mesh=None):
    from .parallel import control as ctl

    rng = np.random.default_rng(6)
    n = POOLS
    inputs = []
    for k in range(WARMUP + TICKS):
        inputs.append(ctl.control_inputs(
            n, samples=rng.uniform(0, 8, n), sojourns=rng.uniform(0, 600, n),
            filtered=rng.uniform(0, 8, n), target_delay=300.0, spares=2.0,
            maximum=16.0, active=True, reset=rng.uniform(size=n) < 0.05,
            now_ms=200.0 * (k + 1)))
    step = ctl.make_control_step(mesh)
    state = [ctl.control_init(n)]
    if mesh is not None:
        state = [ctl.shard_control_state(state[0], mesh)]
        inputs = [ctl.shard_control_inputs(inp, mesh) for inp in inputs]

    def tick(inp):
        state[0] = step(state[0], inp)[0]
    for inp in inputs[:WARMUP]:
        tick(inp)
    return [lambda inp=inp: tick(inp) for inp in inputs[WARMUP:]]


def _health(mesh=None):
    from .entry import health_example_columns
    from .parallel import health as hl

    inp = hl.health_inputs(BACKENDS, now_ms=np.float32(1000.0),
                           **health_example_columns(BACKENDS))
    step = hl.make_health_step(mesh)
    state = [hl.health_init(BACKENDS)]
    if mesh is not None:
        state = [hl.shard_health_state(state[0], mesh)]
        inp = hl.shard_health_inputs(inp, mesh)

    def tick():
        state[0] = step(state[0], inp)[0]
    for _ in range(WARMUP):
        tick()
    return [tick] * TICKS


def _sampler(mesh=None):
    from .entry import SamplerWorkload
    from .parallel.sampler import FleetSampler

    work = SamplerWorkload(SAMPLER_POOLS)
    s = FleetSampler(work.options(mesh=mesh))

    def tick():
        work.advance()
        s.sample_once()
    for _ in range(WARMUP):
        tick()
    return [tick] * TICKS


class _Router:
    """One ShardedWorkload on the card with a FleetRuntime over it,
    driven from a loop of the calling thread."""

    def __init__(self):
        from .entry import ShardedWorkload
        from .shard import FleetRuntime

        self.work = ShardedWorkload(SHARDS, SAMPLER_POOLS // SHARDS)
        self.runtime = FleetRuntime(self.work, self.work.options())
        self.loop = asyncio.new_event_loop()

    def passes(self, kind: str) -> list:
        """Warm-up passes of ``kind``, then the profiled ones."""
        def tick():
            self.work.advance()
            self.loop.run_until_complete(
                getattr(self.runtime, kind + '_fleet')())
        for _ in range(WARMUP):
            tick()
        return [tick] * TICKS

    def close(self) -> None:
        self.loop.run_until_complete(self.runtime.stop())
        self.loop.close()
        self.work.close()


def main() -> int:
    if not torch.cuda.is_available():
        print('profile_live: no CUDA device', file=sys.stderr)
        return 1
    summaries = []
    mesh = _mesh()
    router = None
    try:
        for name, make, on in (
                ('live', _live, None), ('control', _control, None),
                ('health', _health, None), ('sampler', _sampler, None),
                ('sharded_live', _live, mesh),
                ('sharded_control', _control, mesh),
                ('sharded_health', _health, mesh),
                ('mesh_sampler', _sampler, mesh),
                ('router_sample', None, 'sample'),
                ('router_control', None, 'control'),
                ('router_health', None, 'health')):
            if make is None:
                router = router or _Router()
                ticks = router.passes(on)
            else:
                ticks = make(on)
            summaries.append(_profile(name, ticks))
    except NoDeviceEvents as e:
        print('profile_live: %s' % e, file=sys.stderr)
        return 1
    finally:
        if router is not None:
            router.close()
    for summary in summaries:
        print(json.dumps(summary))
    return 0


if __name__ == '__main__':
    sys.exit(main())
