"""The ``routed_passes`` generator: a ``routed_synthetic_fleet``
configuration behind the program's ``FleetRouter``, its fleet passes
run back to back from the router's loop.

The router has ``shards`` thread shards on a ring of ``replicas``
points a shard and seed ``ring_seed``. Pool ``i`` (the fleet
generator's ``SyntheticPool``) is created with ``router.create_pool``
under the name ``pool-%05d``, so it lives on the shard its name hashes
to, and registers itself with the run's pool monitor from that shard's
loop. Every other option of the configuration goes to the shards'
samplers, one per shard, each of ``capacity`` rows.

Passes repeat in the cycle sample, sample, sample, control, health
(``router.sample_fleet``, ``control_fleet``, ``health_fleet``) on a
frozen clock that moves ``tick_ms`` before each. Before a pass, as in
the fleet generator, ``churn_share`` of the pools take a new load in
``[0, load_values)`` and ``claims_per_tick`` finished claims over
``backends`` backends are drawn; each claim goes to a pool drawn
uniformly. Each shard's loads are set, and its claims offered to the
host's backend sinks as a claim tracer would offer them, in one job on
that shard's loop, shard by shard. Set-up runs ``warm_ticks`` passes,
quiet but for the last ``warm_traffic_ticks``. Every draw comes from
the run's seed and is logged, so the reference works out every pass's
inputs from them alone.

A traced run leaves two per-layer readings in :data:`LAYER_READINGS`
once its traced passes end, for the metric readers to import: the
mean, over the traced passes, of the shards' job milliseconds (the
router's per-shard job counters, which time each shard job's range:
the profiler records the router's thread only) and of the pass range
less those jobs and the reduce range. Against a program without those
ranges and counters they stay unset.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np

from ..harness import Tracer, WindowRecords
from ..reference import routed
from .fleet_ticks import SyntheticPool, frozen_host, registry_keys

#: Per-layer readings of the last traced run, by metric name.
LAYER_READINGS: dict = {}

PASS_RANGE = 'cueball.router.pass'
REDUCE_RANGE = 'cueball.router.reduce'

#: Pools created concurrently at a time.
_BATCH = 4096

_QUIET = (np.zeros(0, np.int64), np.zeros(0), np.zeros(0, np.int64),
          np.zeros(0, np.int64), np.zeros(0), np.zeros(0, bool))


class RoutedRun:
    """One run of a ``routed_passes`` cell on ``device``."""

    def __init__(self, cell, seed: int, device):
        from cueball_tpu_torch import host
        from cueball_tpu_torch.monitor import PoolMonitor
        from cueball_tpu_torch.shard import FleetRouter

        LAYER_READINGS.clear()
        cfg, tr = cell.config, cell.traffic
        self.cfg, self.tr = cfg, tr
        self.host = host
        self.initial_keys = registry_keys(host)
        self.clock = [float(cfg['clock_start_ms'])]
        self.monitor = PoolMonitor()
        self.router = FleetRouter({
            'shards': int(cfg['shards']), 'backend': cfg['backend'],
            'replicas': int(cfg['replicas']), 'seed': int(cfg['ring_seed']),
            'monitor': self.monitor, 'device': device,
            'host': frozen_host(self.clock, host),
            'taps': int(cfg['taps']), 'capacity': int(cfg['capacity']),
            'interval': int(cfg['tick_ms']), 'control': bool(cfg['control']),
            'health': bool(cfg['health']), 'actuate': bool(cfg['actuate'])})
        self.loop = asyncio.new_event_loop()
        self.pools = [None] * int(cfg['pools'])
        self.loop.run_until_complete(self._build())
        # Where the router placed each pool: its loads and claims go
        # to that shard's loop.
        placed = self.router.fr_pools
        self.owner = np.array([placed[routed.pool_name(i)].shard_id
                               for i in range(len(self.pools))], np.int64)
        self.rng = np.random.default_rng(seed)
        self.keys = ['backend-%d' % b for b in range(int(tr['backends']))]
        self.n_churn = int(round(len(self.pools) * float(tr['churn_share'])))
        self.log = []     # per pass: (rows, loads, pools, backends, ms, ok)
        self.passes = 0
        self._traced = []   # per traced pass: its shard job ms
        self.records = WindowRecords(int(tr['checked_ticks']), seed)

    def _pool(self, i: int):
        """Pool ``i``, built on its shard's loop."""
        cfg = self.cfg
        pool = SyntheticPool(
            i, int(cfg['spares']), int(cfg['maximum']),
            float(i % int(cfg['initial_load_mod'])),
            (float(cfg['codel_target_ms'])
             if i % int(cfg['codel_every']) == 0 else None),
            (self.clock[0] - float(i % int(cfg['waiter_age_mod_ms']))
             if i % int(cfg['waiter_every']) == 0 else None),
            bool(cfg['control_actuation']))
        self.monitor.register_pool(pool)
        self.pools[i] = pool
        return pool

    async def _build(self) -> None:
        await self.router.start()
        n = len(self.pools)
        for lo in range(0, n, _BATCH):
            await asyncio.gather(*(
                self.router.create_pool(routed.pool_name(i),
                                        factory=lambda i=i: self._pool(i))
                for i in range(lo, min(lo + _BATCH, n))))

    # -- one pass ---------------------------------------------------------

    def _draw(self, quiet: bool):
        self.clock[0] += float(self.cfg['tick_ms'])
        if quiet:
            self.log.append(None)
            return _QUIET
        rng, tr = self.rng, self.tr
        n = len(self.pools)
        rows = rng.choice(n, self.n_churn, replace=False)
        loads = rng.integers(0, int(tr['load_values']), self.n_churn
                             ).astype(np.float64)
        c = int(tr['claims_per_tick'])
        at = rng.integers(0, n, c)
        b = rng.integers(0, len(self.keys), c)
        lo, hi = tr['latency_ms']
        ms = rng.uniform(float(lo), float(hi), c)
        ms = np.where(b == int(tr['slow_backend']),
                      ms * float(tr['slow_factor']), ms)
        ok = rng.random(c) >= float(tr['fail_share'])
        draws = (rows, loads, at, b, ms, ok)
        self.log.append(draws)
        return draws

    def _offer(self, rows, loads, b, ms, ok) -> None:
        """On a shard's loop: its pools' new loads, then its finished
        claims to every backend sink."""
        pools, keys = self.pools, self.keys
        for r, v in zip(rows.tolist(), loads.tolist()):
            pools[r].set_load(v)
        sinks = self.host.backend_sinks()
        for bi, m, good in zip(b.tolist(), ms.tolist(), ok.tolist()):
            for sink in sinks:
                sink.observe(keys[bi], m if good else None, m + 1.0, good)

    async def _advance(self, draws) -> None:
        rows, loads, at, b, ms, ok = draws
        if not len(rows) and not len(b):
            return
        row_shard, claim_shard = self.owner[rows], self.owner[at]
        for s in range(int(self.cfg['shards'])):
            here, mine = row_shard == s, claim_shard == s
            await self.router.run_on(s, self._offer, rows[here], loads[here],
                                     b[mine], ms[mine], ok[mine])

    async def _run_pass(self, kind: str) -> tuple:
        router = self.router
        t0 = time.perf_counter()
        if kind == 'sample':
            reduced = await router.sample_fleet()
        elif kind == 'control':
            reduced = await router.control_fleet()
        else:
            reduced = await router.health_fleet()
        return reduced, time.perf_counter() - t0

    def run_pass(self, quiet: bool = False, tracer: Tracer | None = None):
        """Draw and offer one pass's traffic, then run the pass. Returns
        (the pass record, its seconds on the router's loop)."""
        self.loop.run_until_complete(self._advance(self._draw(quiet)))
        kind = routed.CYCLE[self.passes % len(routed.CYCLE)]
        if tracer is not None and tracer.active:
            jobs = self._job_ms()
            with tracer.tick():
                reduced, dt = self.loop.run_until_complete(
                    self._run_pass(kind))
            self._traced.append(None if jobs is None
                                else self._job_ms() - jobs)
        else:
            reduced, dt = self.loop.run_until_complete(self._run_pass(kind))
        self.passes += 1
        samplers = self.router.fr_samplers
        rec = {'kind': kind, 'reduced': reduced,
               'shards': [samplers[s].fs_latest for s in sorted(samplers)]}
        return rec, dt

    def _job_ms(self):
        """The router's total shard job milliseconds so far, or None on
        a program that does not count them."""
        jobs = getattr(self.router.fr_runtime, 'rt_job_ms', None)
        return None if jobs is None else sum(jobs.values())

    # -- the harness's phases ----------------------------------------------

    def setup(self) -> None:
        """``warm_ticks`` passes back to back, so that every row passes
        its warm-up gate; only the last ``warm_traffic_ticks`` carry the
        mix. Then every shard's sampler must still hold ``capacity``
        rows."""
        n = int(self.tr['warm_ticks'])
        loud = int(self.tr['warm_traffic_ticks'])
        for i in range(n):
            self.run_pass(quiet=i < n - loud)
        caps = {s: smp.fs_capacity
                for s, smp in self.router.fr_samplers.items()}
        if set(caps.values()) != {int(self.cfg['capacity'])}:
            raise RuntimeError('a shard sampler grew: capacities %r' % caps)

    def window(self, seconds: float, tracer: Tracer | None) -> dict:
        """Passes back to back for ``seconds``; the traced passes sit in
        the middle of the window."""
        tick_s, records = [], self.records
        self._traced = []
        t_open = time.perf_counter()
        deadline = t_open + seconds
        half = t_open + seconds / 2.0
        while True:
            now = time.perf_counter()
            if now >= deadline:
                break
            if tracer is not None and now >= half:
                tracer.maybe_start()
            rec, dt = self.run_pass(tracer=tracer)
            tick_s.append(dt)
            records.offer(self.passes, rec)
        t_close = time.perf_counter()
        records.keep_last(self.passes, rec)
        if tracer is not None:
            tracer.finish()
            self._read_layers(tracer)
        return {'window_s': t_close - t_open, 'tick_s': tick_s,
                'attempted': len(tick_s), 'failed': 0}

    def _read_layers(self, tracer: Tracer) -> None:
        """The per-layer readings of the traced passes, from the
        tracer's profile and the router's job counters."""
        if tracer.prof is None or not self._traced or \
                any(j is None for j in self._traced):
            return
        from ..tracing import events_of

        events = events_of(tracer.prof)
        ticks = sorted((s, e) for n, k, s, e, _ in events if k == 'tick')
        spans = [(n, s, e) for n, k, s, e, _ in events
                 if n in (PASS_RANGE, REDUCE_RANGE)]
        if len(ticks) != len(self._traced):
            return
        hops = []
        for (ts, te), jobs in zip(ticks, self._traced):
            inside = [(n, e - s) for n, s, e in spans if ts <= s < te]
            pass_us = sum(d for n, d in inside if n == PASS_RANGE)
            if not pass_us:
                return
            reduce_us = sum(d for n, d in inside if n == REDUCE_RANGE)
            hops.append(pass_us / 1e3 - reduce_us / 1e3 - jobs)
        LAYER_READINGS['router_hop_ms_per_pass'] = float(np.mean(hops))
        LAYER_READINGS['shard_job_ms_per_pass'] = float(
            np.mean(self._traced))

    def close(self) -> None:
        try:
            self.loop.run_until_complete(self.router.stop())
        finally:
            self.loop.close()

    def check(self, device, control: bool = False) -> dict:
        """Readings of the program against the reference over every pass
        of the run, compared at the passes kept. With ``control``, the
        reference in lower precision stands in the program's place."""
        cfg = self.cfg
        owner = routed.split(cfg)
        model = routed.RoutedModel(cfg, owner)
        refs = [routed.RoutedFollower(cfg, device, lowp=lowp,
                                      initial_keys=self.initial_keys)
                for lowp in ((False, True) if control else (False,))]
        kept = dict(self.records.kept)
        shards = range(int(cfg['shards']))
        readings = []
        for k, draws in enumerate(self.log, start=1):
            rows, loads, at, b, ms, ok = draws or _QUIET
            cols, now, shift = model.tick(rows, loads)
            groups = [(b[m], ms[m], ok[m])
                      for m in (owner[at] == s for s in shards)]
            outs = []
            for ref in refs:
                if shift is not None:
                    ref.rebase(shift)
                if k > 1:
                    # The health tables join the sinks during pass 1.
                    ref.observe(self.keys, groups)
                outs.append(ref.tick(cols, now))
            counts = [model.actuate(k, s, outs[0][s]['control'])
                      if 'control' in outs[0][s] else (0, 0)
                      for s in shards]
            if k in kept:
                kind = routed.CYCLE[(k - 1) % len(routed.CYCLE)]
                want = routed.expected(kind, outs[0], counts)
                got = kept[k]
                if control:
                    got = routed.stand_in(
                        routed.expected(kind, outs[1], counts), cols,
                        model.members)
                readings.append(routed.compare_pass(
                    got, want, cols, model.members, owner))
        out = routed.merge(readings)
        out['missing_ticks'] = self.records.wanted - len(readings)
        return out


Run = RoutedRun
