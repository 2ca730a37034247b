"""Scenario harness: schedules, herds, envelopes, replay dumps.

A ``Scenario`` binds a name + seed to a fault schedule and runs a
coroutine under the virtual loop with the FSM transition trace
captured — the same ``fsm.add_transition_tracer`` tuple stream
tests/test_runq_conformance.py pins — so any run is replayable
byte-identically from its seed. On failure it writes a JSON dump
(seed, schedule, error) and appends a one-command replay hint to the
exception, per the corpus contract in docs/netsim.md.

Also here: the thundering-herd client-arrival generator (burst and
Poisson arrivals through the real ``pool.claim_cb`` path, per-client
outcome + latency records) and small envelope statistics
(``quantile``, Jain's fairness index) scenarios assert against.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys

from .. import fsm as mod_fsm
from .. import trace as mod_trace
from .. import utils as mod_utils
from .clock import VirtualClock, run as vrun

# The package this netsim belongs to: its wiretap and health modules
# are looked up late, by name.
_PKG = __name__.rpartition('.netsim.')[0]

DUMP_DIR_ENV = 'CUEBALL_SCENARIO_DUMP_DIR'
DEFAULT_DUMP_DIR = '.netsim-failures'


class Scenario:
    """One named, seeded, scheduled virtual-time run."""

    def __init__(self, name: str, seed: int):
        self.name = name
        self.seed = seed
        self.clock = VirtualClock()
        self.schedule: list[tuple[float, str, object]] = []
        self.fired: list[tuple[float, str]] = []
        self.trace: list[tuple[str, str, str]] = []
        self._loop = None

    def at(self, t_s: float, label: str, fn) -> 'Scenario':
        """Run ``fn()`` at virtual time ``t_s`` (from run start).
        Usable both before ``run`` and from inside the running
        coroutine — in the latter case the timer is armed on the live
        loop immediately."""
        self.schedule.append((t_s, label, fn))
        if self._loop is not None:
            delay = max(0.0, t_s - self.clock.monotonic())
            self._loop.call_later(delay, self._fire, label, fn)
        return self

    def _fire(self, label: str, fn) -> None:
        self.fired.append((self.clock.monotonic(), label))
        fn()

    def metadata(self) -> dict:
        return {
            'scenario': self.name,
            'seed': self.seed,
            'schedule': [[t, label] for t, label, _ in self.schedule],
        }

    def run(self, main, timeout_s: float | None = None):
        """Run ``main`` (a no-arg callable returning a coroutine)
        under the virtual loop with the schedule armed and the FSM
        transition trace captured into ``self.trace``. ``timeout_s``
        bounds VIRTUAL time."""

        async def wrapper():
            loop = asyncio.get_running_loop()
            for t_s, label, fn in self.schedule:
                loop.call_later(t_s, self._fire, label, fn)
            self._loop = loop
            coro = main()
            if timeout_s is not None:
                return await asyncio.wait_for(coro, timeout_s)
            return await coro

        def tracer(fsm_obj, old, new):
            self.trace.append((type(fsm_obj).__name__, old, new))

        mod_fsm.add_transition_tracer(tracer)
        mod_trace.set_run_metadata(self.metadata())
        try:
            return vrun(wrapper(), seed=self.seed, clock=self.clock)
        except BaseException as err:
            self._dump_failure(err)
            raise
        finally:
            self._loop = None
            mod_fsm.remove_transition_tracer(tracer)
            mod_trace.set_run_metadata(None)

    def _dump_failure(self, err: BaseException) -> None:
        """Persist everything needed to replay this exact run and
        print the one-command replay recipe."""
        dump_dir = os.environ.get(DUMP_DIR_ENV, DEFAULT_DUMP_DIR)
        path = os.path.join(
            dump_dir, '%s-seed%d.json' % (self.name, self.seed))
        record = dict(self.metadata())
        record.update({
            'error': '%s: %s' % (type(err).__name__, err),
            'virtual_time_s': self.clock.monotonic(),
            'fired': [[t, label] for t, label in self.fired],
            'transitions': len(self.trace),
            'replay': 'python -m pytest "tests/scenarios" -k '
                      '"%s and %d" -q' % (self.name, self.seed),
        })
        if mod_trace._runtime is not None:
            # Tracing was on for this run: embed the slowest completed
            # claim/DNS traces (full span lists, the NDJSON records
            # parsed back) so the dump shows WHERE the slow claims
            # spent their time, not just that the envelope broke.
            # trace_ring() drains the native ring first, so this works
            # identically under either recorder.
            try:
                done = [t for t in mod_trace.trace_ring()
                        if t.root.end is not None]
                done.sort(key=lambda t: t.root.end - t.root.start,
                          reverse=True)
                record['trace_summary'] = mod_trace.summary()
                record['slowest_traces'] = [
                    [json.loads(line) for line in t.ndjson_lines()]
                    for t in done[:3]]
                # Phase ledger of the same slowest claims: the dump
                # answers "queue wait or service time?" without the
                # reader re-deriving it from raw spans. Pure replay
                # arithmetic — no sampler under VirtualClock.
                from .. import profile as mod_profile
                ledgers = mod_profile.phase_ledger(done)
                if ledgers:
                    record['phase_ledger'] = {
                        'summary': mod_profile.ledger_summary(ledgers),
                        'slowest_claims': sorted(
                            ledgers, key=lambda led: led['wall_ms'],
                            reverse=True)[:3],
                    }
            except Exception:
                pass  # the dump must never mask the original error
        wiretap = sys.modules.get(_PKG + '.wiretap')
        if wiretap is not None and wiretap.wiretap_enabled():
            # The wire ledger was live during this scenario: embed the
            # per-seam counters and socket_wait wire totals so the
            # dump answers "did the bytes move, and where did the
            # connect time go" next to the slow traces.
            try:
                record['wiretap'] = {
                    'transports': wiretap.snapshot(),
                    'wire_ms': wiretap.wire_totals(),
                    'loop_lag': wiretap.loop_lag_stats(),
                }
            except Exception:
                pass  # same rule: never mask the original error
        health = sys.modules.get(_PKG + '.parallel.health')
        if health is not None:
            # The health engine ran during this scenario: embed every
            # active monitor's verdict history, so the dump answers
            # "which backend was judged gray, and when" next to the
            # slow traces. Late-bound like the other device surfaces —
            # a scenario that never imported it pays nothing.
            try:
                monitors = health.active_monitors()
                if monitors:
                    record['health'] = {
                        'fleet': health.reduce_health(
                            [m.hm_last for m in monitors]),
                        'history': [list(m.hm_history)
                                    for m in monitors],
                    }
            except Exception:
                pass  # same rule: never mask the original error
        try:
            os.makedirs(dump_dir, exist_ok=True)
            with open(path, 'w') as f:
                json.dump(record, f, indent=2)
                f.write('\n')
            sys.stderr.write(
                'netsim scenario %r seed=%d FAILED at virtual '
                't=%.3fs — dump: %s\n  replay: %s\n' % (
                    self.name, self.seed, self.clock.monotonic(),
                    path, record['replay']))
        except OSError:
            pass          # dumping is best-effort; the assert rules


# ---------------------------------------------------------------------------
# Thundering-herd client arrivals

async def herd(pool, count: int, rate_per_s: float | None = None,
               timeout_ms: float = 2000.0, hold_s: float | None = None,
               rng=None, cohort=None) -> list[dict]:
    """Launch ``count`` claim attempts against ``pool`` — a burst at
    t=0 when ``rate_per_s`` is None, else Poisson arrivals at that
    rate — through the real claim_cb path. Each client claims with
    ``timeout_ms``, holds for ``hold_s`` (None = one simulated request
    via SimConnection.request(), or 1ms), then releases. Returns one
    record per client: {idx, cohort, t_arrive_s, ok, err, latency_ms}.
    """
    if rng is None:
        rng = mod_utils.get_rng()
    loop = asyncio.get_running_loop()
    clk = mod_utils.get_clock()

    async def one(idx: int, delay_s: float) -> dict:
        await asyncio.sleep(delay_s)
        rec = {'idx': idx, 't_arrive_s': clk.monotonic(),
               'cohort': cohort(idx) if cohort else None,
               'ok': False, 'err': None, 'latency_ms': None}
        t0 = mod_utils.current_millis()
        fut = loop.create_future()

        def cb(err, hdl=None, conn=None):
            if not fut.done():
                fut.set_result((err, hdl, conn))
        pool.claim_cb({'timeout': timeout_ms}, cb)
        err, hdl, conn = await fut
        rec['latency_ms'] = mod_utils.current_millis() - t0
        if err is not None:
            rec['err'] = type(err).__name__
            return rec
        listener = conn.on('error', lambda e=None: None)
        try:
            if hold_s is not None:
                await asyncio.sleep(hold_s)
            elif hasattr(conn, 'request'):
                await conn.request()
            else:
                await asyncio.sleep(0.001)
        finally:
            conn.remove_listener('error', listener)
            try:
                hdl.release()
            except Exception as rel_err:
                rec['err'] = type(rel_err).__name__
                return rec
        rec['ok'] = True
        return rec

    delay = 0.0
    tasks = []
    for i in range(count):
        if rate_per_s is not None:
            delay += rng.expovariate(rate_per_s)
        tasks.append(asyncio.ensure_future(one(i, delay)))
    return list(await asyncio.gather(*tasks))


# ---------------------------------------------------------------------------
# Envelope statistics

def quantile(values, q: float) -> float:
    """Nearest-rank quantile; q in [0, 1]."""
    if not values:
        raise ValueError('quantile of empty sequence')
    ordered = sorted(values)
    idx = min(len(ordered) - 1, max(0, round(q * (len(ordered) - 1))))
    return ordered[idx]


def jain_index(values) -> float:
    """Jain's fairness index over per-cohort rates: 1.0 = perfectly
    fair, 1/n = one cohort got everything."""
    values = list(values)
    if not values or all(v == 0 for v in values):
        return 1.0
    num = sum(values) ** 2
    den = len(values) * sum(v * v for v in values)
    return num / den


def success_rates(outcomes, key='cohort') -> dict:
    """Per-cohort success rate from herd() records."""
    totals: dict = {}
    oks: dict = {}
    for rec in outcomes:
        c = rec[key]
        totals[c] = totals.get(c, 0) + 1
        oks[c] = oks.get(c, 0) + (1 if rec['ok'] else 0)
    return {c: oks[c] / totals[c] for c in totals}
