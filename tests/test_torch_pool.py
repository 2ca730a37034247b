"""The port's pool layer (``cueball_tpu_torch.pool`` and the modules
under it) against the JAX package's, bit for bit.

Each scenario of ``tests/test_pool.py``'s kind is one coroutine over a
package bundle, run once over each package: on a fresh virtual-time loop
(``cueball_tpu.netsim.clock.VirtualLoop``: timers fire in deadline
order at CPU speed, nothing sleeps), with that clock set in the
package's ``utils.set_clock`` and a ``random.Random`` of one seed in its
``utils.set_rng``. The two runs go one after the other rather than
interleaved on one loop, so that neither package's timers can reorder
the other's ties. The connection class and the resolver are built on
each package's own ``EventEmitter``.

At every step the record holds the pool's ``stateChanged`` sequence, its
slot FSMs' state histogram per backend, its ``p_*`` counters, the
backoff delays its slots drew (through ``utils.delay``), each claim's
result or error (class name and message), ``lp_load_sample()``, the
dead-backend marks and the virtual time; the two records must be
equal.
"""

import asyncio
import collections
import random
import types

import pytest

pytest.importorskip('torch')

from cueball_tpu import events as j_events  # noqa: E402
from cueball_tpu import pool as j_pool  # noqa: E402
from cueball_tpu import resolver as j_resolver  # noqa: E402
from cueball_tpu import utils as j_utils  # noqa: E402
from cueball_tpu.netsim.clock import VirtualClock, VirtualLoop  # noqa: E402
from cueball_tpu_torch import events as t_events  # noqa: E402
from cueball_tpu_torch import pool as t_pool  # noqa: E402
from cueball_tpu_torch import resolver as t_resolver  # noqa: E402
from cueball_tpu_torch import utils as t_utils  # noqa: E402

JAX = types.SimpleNamespace(events=j_events, pool=j_pool,
                            resolver=j_resolver, utils=j_utils)
PORT = types.SimpleNamespace(events=t_events, pool=t_pool,
                             resolver=t_resolver, utils=t_utils)
SEED = 11


async def settle(n=10):
    for _ in range(n):
        await asyncio.sleep(0)


class Run:
    """One scenario's pool over one package, and its record."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.conns = []
        self.changes = []
        self.delays = []
        self.claims = []
        self.steps = []
        self.pool = None
        ee = pkg.events.EventEmitter
        run = self

        class Conn(ee):
            def __init__(self, backend):
                super().__init__()
                self.backend = backend['key']
                self.connected = False
                self.dead = False
                run.conns.append(self)

            def connect(self):
                self.connected = True
                self.emit('connect')

            def ref(self):
                pass

            def unref(self):
                pass

            def destroy(self):
                self.connected = False
                self.dead = True

        class Inner(ee):
            """A resolver the scenario drives: ``added``/``removed``
            emitted by hand."""

            def __init__(self):
                super().__init__()
                self.backends = {}
                self.on('added', lambda k, b: self.backends.__setitem__(
                    k, b))
                self.on('removed', lambda k: self.backends.pop(k, None))

            def start(self):
                self.emit('updated')

            def stop(self):
                pass

            def count(self):
                return len(self.backends)

            def list(self):
                return dict(self.backends)

        self.Conn, self.Inner = Conn, Inner

    def make_pool(self, spares, maximum, retries=1, timeout=500, delay=0,
                  **opts):
        inner = self.Inner()
        res = self.pkg.resolver.ResolverFSM(inner, {})
        res.start()
        self.pool = self.pkg.pool.ConnectionPool({
            'domain': 'parity.local', 'spares': spares, 'maximum': maximum,
            'constructor': self.Conn,
            'recovery': {'default': {'timeout': timeout, 'retries': retries,
                                     'delay': delay}},
            'resolver': res, **opts})
        self.pool.on('stateChanged', self.changes.append)
        return self.pool, inner

    def connect_pending(self):
        """Connect every connection not yet connected nor destroyed."""
        for c in list(self.conns):
            if not c.connected and not c.dead:
                c.connect()

    def claim(self, options=None):
        """A callback claim whose outcome lands in the record, in the
        order claims were made; returns the outcome's future."""
        fut = asyncio.get_running_loop().create_future()
        slot = len(self.claims)
        self.claims.append(None)

        def cb(err, hdl=None, conn=None):
            if err is not None:
                self.claims[slot] = ('error', type(err).__name__, str(err))
            else:
                self.claims[slot] = ('ok', self.conns.index(conn),
                                     conn.backend)
            if not fut.done():
                fut.set_result(hdl)
        self.pool.claim_cb(options or {}, cb)
        return fut

    def snap(self, label):
        pool = self.pool
        slots = {k: sorted(collections.Counter(
            f.get_state() for f in v).items())
            for k, v in pool.p_connections.items()}
        self.steps.append({
            'step': label, 'now': self.pkg.utils.current_millis(),
            'state': pool.get_state(), 'changes': list(self.changes),
            'slots': slots, 'counters': dict(pool.p_counters),
            'delays': list(self.delays), 'claims': list(self.claims),
            'load': pool.lp_load_sample(), 'dead': sorted(pool.p_dead),
            'keys': list(pool.p_keys),
            'conns': [(c.backend, c.connected, c.dead) for c in self.conns]})

    async def stop(self):
        self.pool.stop()
        await asyncio.sleep(1.0)
        self.snap('stopped')


def drive(pkg, scenario, monkeypatch) -> list:
    """``scenario(run)`` over ``pkg`` on a fresh virtual-time loop, its
    clock and a ``Random(SEED)`` set in the package; returns the
    record."""
    run = Run(pkg)
    clock = VirtualClock(start=1000.0)
    loop = VirtualLoop(clock)
    real_delay = pkg.utils.delay

    def delay(*args):
        d = real_delay(*args)
        run.delays.append(d)
        return d
    monkeypatch.setattr(pkg.utils, 'delay', delay)
    old_clock = pkg.utils.set_clock(clock)
    old_rng = pkg.utils.set_rng(random.Random(SEED))
    try:
        asyncio.set_event_loop(loop)
        loop.run_until_complete(asyncio.wait_for(scenario(run), 600))
    finally:
        asyncio.set_event_loop(None)
        loop.close()
        pkg.utils.set_clock(old_clock)
        pkg.utils.set_rng(old_rng)
        monkeypatch.undo()
    return run.steps


async def spares_claim_release(run):
    """Spares fill over two backends, three claims grow the pool past
    them, then every claim is released."""
    pool, inner = run.make_pool(spares=2, maximum=4)
    inner.emit('added', 'b1', {})
    inner.emit('added', 'b2', {})
    await settle()
    run.snap('added')
    run.connect_pending()
    await settle()
    run.snap('connected')
    futs = [run.claim({'timeout': 500}) for _ in range(3)]
    await settle()
    run.snap('claimed')
    run.connect_pending()
    handles = [await f for f in futs]
    run.snap('served')
    for h in handles:
        h.release()
    await settle()
    run.snap('released')
    await asyncio.sleep(0.5)
    run.snap('idle')
    await run.stop()


async def connect_error_recovery(run):
    """A connect error: the slot backs off, retries, errs again and the
    backend is marked dead, failing the pool; claims short-circuit; the
    monitor probe connects and the pool recovers."""
    pool, inner = run.make_pool(spares=1, maximum=2, retries=3,
                                delay=100, timeout=300)
    inner.emit('added', 'b1', {})
    await settle()
    run.snap('added')
    for attempt in (1, 2):
        for c in list(run.conns):
            if not c.dead:
                c.emit('error', Exception('connect refused'))
        await settle()
        run.snap('backoff %d' % attempt)
        await asyncio.sleep(0.25 * attempt)
        run.snap('retry %d' % attempt)
    for c in list(run.conns):
        if not c.dead:
            c.emit('error', Exception('connect refused'))
    await asyncio.sleep(0.05)
    run.snap('dead')
    await run.claim()
    run.snap('short-circuit')
    await asyncio.sleep(0.5)
    run.snap('probing')
    run.connect_pending()
    await settle(30)
    run.snap('recovered')
    hdl = await run.claim({'timeout': 200})
    if hdl is not None:
        hdl.release()
    await settle()
    run.snap('claimed after recovery')
    await run.stop()


async def claim_timeout(run):
    """Connections that never connect: a claim times out."""
    pool, inner = run.make_pool(spares=2, maximum=2, timeout=1000)
    inner.emit('added', 'b1', {})
    await settle()
    fut = run.claim({'timeout': 100})
    await asyncio.sleep(0.05)
    run.snap('queued')
    await fut
    run.snap('timed out')
    run.connect_pending()
    await settle()
    hdl = await run.claim({'timeout': 100})
    hdl.release()
    await settle()
    run.snap('served')
    await run.stop()


async def codel_shedding(run):
    """CoDel on a two-connection pool fed three claims every 10 ms, each
    held 50 ms, on a clock that moves only when the loop is idle: the
    queue stands above the 100 ms target and claims are shed."""
    pool, inner = run.make_pool(spares=2, maximum=2, timeout=2000,
                                targetClaimDelay=100)
    inner.emit('added', 'b1', {})
    await settle()
    run.connect_pending()
    await settle()
    loop = asyncio.get_running_loop()
    futs = []

    def hold(fut):
        hdl = fut.result()
        if hdl is not None:
            loop.call_later(0.05, hdl.release)
    for tick in range(60):
        for _ in range(3):
            fut = run.claim()
            fut.add_done_callback(hold)
            futs.append(fut)
        await asyncio.sleep(0.01)
        if tick % 10 == 9:
            run.snap('tick %d' % tick)
    await asyncio.gather(*futs)
    await asyncio.sleep(0.2)
    run.snap('drained')
    await run.stop()


async def backend_removed(run):
    """The resolver drops a backend: its slots go, its dead mark (if any)
    is cleared, and the pool rebalances onto the others."""
    pool, inner = run.make_pool(spares=3, maximum=4, timeout=100)
    for key in ('b1', 'b2', 'b3'):
        inner.emit('added', key, {})
    await settle()
    run.connect_pending()
    await settle()
    run.snap('three backends')
    hdl = await run.claim({'timeout': 100})
    run.snap('claimed')
    inner.emit('removed', 'b2')
    await settle()
    run.snap('removed')
    run.connect_pending()
    await asyncio.sleep(0.3)
    run.snap('rebalanced')
    hdl.release()
    await settle()
    inner.emit('removed', 'b1')
    await asyncio.sleep(0.05)
    run.connect_pending()
    await asyncio.sleep(0.3)
    run.snap('one backend')
    await run.stop()


@pytest.mark.parametrize('scenario', [
    spares_claim_release, connect_error_recovery, claim_timeout,
    codel_shedding, backend_removed], ids=lambda f: f.__name__)
def test_pool_matches_jax(scenario, monkeypatch):
    want = drive(JAX, scenario, monkeypatch)
    got = drive(PORT, scenario, monkeypatch)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, g['step']
    # The scenario did what it says.
    last = want[-1]
    assert last['state'] == 'stopped'
    assert any(s['claims'] for s in want)
    if scenario is connect_error_recovery:
        assert 'failed' in last['changes'] and len(last['delays']) >= 2
    if scenario is claim_timeout:
        assert last['claims'][0][1] == 'ClaimTimeoutError'
    if scenario is codel_shedding:
        assert last['counters'].get('codel-paced-drop', 0) + sum(
            c[1] == 'ClaimTimeoutError' for c in last['claims']) > 0
