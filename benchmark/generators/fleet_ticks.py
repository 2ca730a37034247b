"""The ``fleet_ticks`` generator: a ``synthetic_fleet`` configuration
sampled tick after tick, back to back, by one ``FleetSampler``.

The pools are the benchmark's own: each speaks the sampler's push
protocol, reports the load the generator gave it last, and takes the
sampler's advisories and control decisions as a pool with control
actuation on does. Per tick the
generator moves the fleet's clock by ``tick_ms``, gives a new load in
``[0, load_values)`` to ``churn_share`` of the pools, and offers
``claims_per_tick`` finished claims over ``backends`` backends to
every backend sink of the program's host seam, as a claim tracer
would: a service time uniform in ``latency_ms``, ``slow_factor`` times
longer on backend ``slow_backend``, and ``fail_share`` of them failed.
Set-up ticks quietly (the clock alone moves) until its last
``warm_traffic_ticks``. Every draw comes from the run's seed; the
draws are logged, so the reference can work out every tick's inputs
from them alone.
"""

from __future__ import annotations

import math
import time
import types

import numpy as np

from ..harness import Tracer, WindowRecords

#: The pool layer's guards on a decision (``codel.py``, ``pool.py``).
CODEL_TARGET_MIN = 1.0
CODEL_TARGET_MAX = 60_000.0
CONTROL_EPOCH_TTL = 5000.0

#: A quiet tick's draws: no load changes, no claims.
_QUIET = (np.zeros(0, np.int64), np.zeros(0), np.zeros(0, np.int64),
          np.zeros(0), np.zeros(0, bool))


class _Codel:
    def __init__(self, target):
        self.cd_targdelay = target


class _Waiter:
    def __init__(self, started):
        self.ch_started = started

    def is_in_state(self, state):
        return state == 'waiting'


class SyntheticPool:
    """A pool as the sampler reads and actuates it: a load sample, the
    configured spares and maximum, no slot in backoff, an optional
    CoDel target and an optional claim that waits for good.
    :meth:`set_load` marks its rows dirty. With ``control_actuation``
    it takes the sampler's advisories and decisions through the same
    guarded entry points as ``ConnectionPool``, with the same checks;
    it holds no connections, so a new spares target has nothing to
    grow or shrink."""

    def __init__(self, i: int, spares: int, maximum: int, load: float,
                 codel_target: float | None, waiting_since: float | None,
                 control_actuation: bool):
        self.p_uuid = 'synthetic-%d' % i
        self.p_spares = spares
        self.p_max = maximum
        self.p_codel = None if codel_target is None else _Codel(codel_target)
        self.p_waiters = (() if waiting_since is None
                          else (_Waiter(waiting_since),))
        self.p_connections = {}
        self.p_control_actuation = control_actuation
        self.p_ctrl_epoch = 0
        self.p_ctrl_at = -math.inf
        self.p_ctrl_health = None
        self.p_fleet_advisory = None
        self.load = load
        self.handles = ()

    def lp_load_sample(self):
        return self.load

    def telemetry_attach(self, handle):
        self.handles = self.handles + (handle,)

    def telemetry_detach(self, handle):
        self.handles = tuple(h for h in self.handles if h is not handle)

    def _dirty(self):
        for h in self.handles:
            h.mark_dirty()

    def set_load(self, v: float):
        self.load = v
        self._dirty()

    def receive_fleet_advisory(self, filtered: float, at_ms: float) -> None:
        self.p_fleet_advisory = (float(filtered), at_ms)

    def apply_control_decision(self, epoch: int, codel_target=None,
                               spares=None, at_ms=None,
                               health=None) -> bool:
        if not self.p_control_actuation:
            return False
        if not isinstance(epoch, int) or isinstance(epoch, bool):
            return False
        stale_ok = at_ms - self.p_ctrl_at > CONTROL_EPOCH_TTL
        if epoch <= self.p_ctrl_epoch and not stale_ok:
            return False
        if codel_target is not None:
            if self.p_codel is None:
                return False
            if not isinstance(codel_target, (int, float)) or \
                    isinstance(codel_target, bool) or \
                    not math.isfinite(codel_target) or \
                    not CODEL_TARGET_MIN <= codel_target <= CODEL_TARGET_MAX:
                return False
        if spares is not None:
            if not isinstance(spares, int) or isinstance(spares, bool) \
                    or spares < 0 or spares > self.p_max:
                return False
        self.p_ctrl_epoch = epoch
        self.p_ctrl_at = at_ms
        if health is not None:
            self.p_ctrl_health = health
        if codel_target is not None and \
                codel_target != self.p_codel.cd_targdelay:
            self.p_codel.cd_targdelay = float(codel_target)
            self._dirty()
        if spares is not None and spares != self.p_spares:
            self.p_spares = spares
            self._dirty()
        return True


def registry_keys(host) -> list:
    """The backend keys the process-wide registry holds now, row order:
    more than the unattributed key only where an earlier fleet ran in
    the same process (the tests, ``benchmark.limits``)."""
    keys, row = [], 0
    while True:
        key = host.backend_key_for(row)
        if key is None:
            return keys
        keys.append(key)
        row += 1


def frozen_host(clock: list, base):
    """The program's host seam ``base`` with its clock read from
    ``clock[0]`` (ms), which the generator moves by hand."""
    names = ('_Interval', 'backend_index', 'backend_key_for',
             'add_backend_sink', 'remove_backend_sink', 'backend_sinks',
             'active_collector', 'loop_lag_p99_us', 'drain_native')
    return types.SimpleNamespace(
        **{name: getattr(base, name) for name in names},
        current_millis=lambda: clock[0])


class FleetRun:
    """One run of a ``fleet_ticks`` cell on ``device``."""

    def __init__(self, cell, seed: int, device):
        from cueball_tpu_torch import host
        from cueball_tpu_torch.monitor import PoolMonitor
        from cueball_tpu_torch.parallel.sampler import FleetSampler

        cfg, tr = cell.config, cell.traffic
        self.cfg, self.tr = cfg, tr
        self.host = host
        self.initial_keys = registry_keys(host)
        self.clock = [float(cfg['clock_start_ms'])]
        n = int(cfg['pools'])
        self.pools = [SyntheticPool(
            i, int(cfg['spares']), int(cfg['maximum']),
            float(i % int(cfg['initial_load_mod'])),
            (float(cfg['codel_target_ms'])
             if i % int(cfg['codel_every']) == 0 else None),
            (self.clock[0] - float(i % int(cfg['waiter_age_mod_ms']))
             if i % int(cfg['waiter_every']) == 0 else None),
            bool(cfg['control_actuation']))
            for i in range(n)]
        self.monitor = PoolMonitor()
        for p in self.pools:
            self.monitor.register_pool(p)
        self.sampler = FleetSampler({
            'monitor': self.monitor, 'device': device,
            'host': frozen_host(self.clock, host),
            'taps': int(cfg['taps']), 'capacity': int(cfg['capacity']),
            'interval': int(cfg['tick_ms']), 'control': bool(cfg['control']),
            'health': bool(cfg['health']), 'actuate': bool(cfg['actuate'])})
        self.rng = np.random.default_rng(seed)
        self.keys = ['backend-%d' % b for b in range(int(tr['backends']))]
        self.n_churn = int(round(n * float(tr['churn_share'])))
        self.log = []          # per tick: (rows, loads, backends, ms, ok)
        self.ticks = 0
        self.records = WindowRecords(int(tr['checked_ticks']), seed)

    def advance(self, quiet: bool = False) -> None:
        """Move the clock one tick and, unless ``quiet``, draw and apply
        the tick's load changes and finished claims."""
        rng, tr = self.rng, self.tr
        self.clock[0] += float(self.cfg['tick_ms'])
        if quiet:
            self.log.append(None)
            return
        rows = rng.choice(len(self.pools), self.n_churn, replace=False)
        loads = rng.integers(0, int(tr['load_values']), self.n_churn
                             ).astype(np.float64)
        c = int(tr['claims_per_tick'])
        b = rng.integers(0, len(self.keys), c)
        lo, hi = tr['latency_ms']
        ms = rng.uniform(float(lo), float(hi), c)
        ms = np.where(b == int(tr['slow_backend']),
                      ms * float(tr['slow_factor']), ms)
        ok = rng.random(c) >= float(tr['fail_share'])
        self.log.append((rows, loads, b, ms, ok))
        pools = self.pools
        for r, v in zip(rows.tolist(), loads.tolist()):
            pools[r].set_load(v)
        sinks = self.host.backend_sinks()
        keys = self.keys
        for bi, m, good in zip(b.tolist(), ms.tolist(), ok.tolist()):
            for sink in sinks:
                sink.observe(keys[bi], m if good else None, m + 1.0, good)

    def sample(self):
        """One ``sample_once``, timed on the host clock."""
        t0 = time.perf_counter()
        rec = self.sampler.sample_once()
        dt = time.perf_counter() - t0
        self.ticks += 1
        return rec, dt

    def tick(self):
        self.advance()
        return self.sample()

    def setup(self) -> None:
        """``warm_ticks`` ticks back to back, so that every row passes
        its warm-up gate; only the last ``warm_traffic_ticks`` carry the
        mix, to fill the registry and the health table."""
        n = int(self.tr['warm_ticks'])
        loud = int(self.tr['warm_traffic_ticks'])
        for i in range(n):
            self.advance(quiet=i < n - loud)
            self.sample()

    def window(self, seconds: float, tracer: Tracer | None) -> dict:
        """Tick back to back for ``seconds``; the traced ticks sit in
        the middle of the window."""
        tick_s, records = [], self.records
        t_open = time.perf_counter()
        deadline = t_open + seconds
        half = t_open + seconds / 2.0
        while True:
            now = time.perf_counter()
            if now >= deadline:
                break
            if tracer is not None and now >= half:
                tracer.maybe_start()
            self.advance()
            if tracer is not None and tracer.active:
                with tracer.tick():
                    rec, dt = self.sample()
            else:
                rec, dt = self.sample()
            tick_s.append(dt)
            records.offer(self.ticks, rec)
        t_close = time.perf_counter()
        records.keep_last(self.ticks, rec)
        return {'window_s': t_close - t_open, 'tick_s': tick_s,
                'attempted': len(tick_s), 'failed': 0}

    def close(self) -> None:
        self.sampler.stop()
        self.sampler = None

    def check(self, device, control: bool = False) -> dict:
        """Readings of the program against the reference over every
        tick of the run, compared at the ticks kept. With ``control``,
        the reference in lower precision stands in the program's
        place."""
        from ..compare import compare_tick, merge
        from ..reference.fleet_model import FleetModel
        from ..reference.follow import Follower, as_record

        cfg = self.cfg
        refs = [Follower(int(cfg['capacity']), int(cfg['taps']), device,
                         lowp=lowp, initial_keys=self.initial_keys)
                for lowp in ((False, True) if control else (False,))]
        model = FleetModel(cfg)
        kept = dict(self.records.kept)
        readings = []
        for k, draws in enumerate(self.log, start=1):
            rows, loads, b, ms, ok = draws or _QUIET
            cols, now, shift = model.tick(rows, loads)
            outs = []
            for ref in refs:
                if shift is not None:
                    ref.rebase(shift)
                if k > 1 and len(b):
                    # The health table joins the sinks during tick 1.
                    ref.backends.observe_many(self.keys, b, ms, ok)
                outs.append(ref.tick(cols, now, bool(cfg['control']),
                                     bool(cfg['health'])))
            if k in kept:
                got = as_record(outs[1], cols) if control else kept[k]
                readings.append(compare_tick(got, outs[0], cols))
            if 'control' in outs[0]:
                # The pools take the reference's decisions. The control
                # rounds lower only where no decision applied reads.
                model.actuate(k, outs[0]['control'])
        out = merge(readings)
        out['missing_ticks'] = self.records.wanted - len(readings)
        return out


Run = FleetRun
