"""The port's ``ConnectionSet`` (``cueball_tpu_torch.cset``) against the
JAX package's, bit for bit.

Each scenario of ``tests/test_cset.py``'s kind is one coroutine over a
package bundle, run once over each package on that package's own
virtual-time loop (``netsim.run``: its clock and a ``random.Random`` of
one seed in the package's ``utils``), one package after the other. The
connection class and the inner resolver are built on each package's own
``EventEmitter``, and the resolver is its ``ResolverFSM``.

At every step the record holds the set's ``stateChanged`` sequence, each
``added``/``removed`` advertisement (backend, and the order of its
handle), the slot FSMs' states per backend, the set's counters, its
preference list, the backoff delays its slots drew (through
``utils.delay``), the connections (backend, connected, dead) and the
virtual time; the two records must be equal.
"""

import asyncio
import types

import pytest

pytest.importorskip('torch')

from cueball_tpu import cset as j_cset  # noqa: E402
from cueball_tpu import events as j_events  # noqa: E402
from cueball_tpu import netsim as j_netsim  # noqa: E402
from cueball_tpu import resolver as j_resolver  # noqa: E402
from cueball_tpu import trace as j_trace  # noqa: E402
from cueball_tpu import utils as j_utils  # noqa: E402
from cueball_tpu import wiretap as j_wiretap  # noqa: E402
from cueball_tpu_torch import cset as t_cset  # noqa: E402
from cueball_tpu_torch import events as t_events  # noqa: E402
from cueball_tpu_torch import netsim as t_netsim  # noqa: E402
from cueball_tpu_torch import resolver as t_resolver  # noqa: E402
from cueball_tpu_torch import trace as t_trace  # noqa: E402
from cueball_tpu_torch import utils as t_utils  # noqa: E402
from cueball_tpu_torch import wiretap as t_wiretap  # noqa: E402

JAX = types.SimpleNamespace(cset=j_cset, events=j_events, netsim=j_netsim,
                            resolver=j_resolver, utils=j_utils)
PORT = types.SimpleNamespace(cset=t_cset, events=t_events, netsim=t_netsim,
                             resolver=t_resolver, utils=t_utils)
SEED = 13


@pytest.fixture(autouse=True)
def tracers_off():
    """Each test starts with both packages' claim tracers and wire
    ledgers off: one left on by another test would draw from the seeded
    RNG and count into the records."""
    for trace, wiretap in ((j_trace, j_wiretap), (t_trace, t_wiretap)):
        trace.disable_tracing()
        wiretap.disable_wiretap()
    yield


async def settle(n=10):
    for _ in range(n):
        await asyncio.sleep(0)


class Run:
    """One scenario's set over one package, and its record."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.conns = []
        self.changes = []
        self.adverts = []
        self.delays = []
        self.steps = []
        self.cset = self.resolver = self.inner = None
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

    def make_set(self, target, maximum, retries=1, timeout=500, delay=0,
                 release=True, on_error=False):
        """A set over a hand-driven resolver. Its ``removed`` handler
        releases the handle when ``release``; with ``on_error`` every
        advertised connection gets an error listener, as a consumer that
        handles errors has."""
        self.inner = self.Inner()
        self.resolver = self.pkg.resolver.ResolverFSM(self.inner, {})
        self.resolver.start()
        self.cset = self.pkg.cset.ConnectionSet({
            'constructor': self.Conn,
            'recovery': {'default': {'timeout': timeout, 'retries': retries,
                                     'delay': delay}},
            'target': target, 'maximum': maximum,
            'resolver': self.resolver})
        self.cset.on('stateChanged', self.changes.append)

        def added(key, conn, hdl):
            self.adverts.append(('added', key.rpartition('.')[0],
                                 self.conns.index(conn)))
            if on_error:
                conn.on('error', lambda e: None)

        def removed(key, conn, hdl):
            self.adverts.append(('removed', key.rpartition('.')[0],
                                 self.conns.index(conn), conn.dead))
            if release:
                hdl.release()
        self.cset.on('added', added)
        self.cset.on('removed', removed)
        return self.cset

    def connect_pending(self):
        for c in list(self.conns):
            if not c.connected and not c.dead:
                c.connect()

    def snap(self, label):
        cs = self.cset
        self.steps.append({
            'step': label, 'now': self.pkg.utils.current_millis(),
            'state': cs.get_state(), 'changes': list(self.changes),
            'adverts': list(self.adverts),
            'fsms': {k: f.get_state() for k, f in cs.cs_fsm.items()},
            'connections': sorted(k.rpartition('.')[0]
                                  for k in cs.cs_connections),
            'counters': dict(cs.cs_counters), 'keys': list(cs.cs_keys),
            'dead': sorted(cs.cs_dead), 'delays': list(self.delays),
            'conns': [(c.backend, c.connected, c.dead) for c in self.conns]})

    async def stop(self):
        self.cset.stop()
        self.resolver.stop()
        for _ in range(200):
            if self.cset.is_in_state('stopped'):
                break
            await asyncio.sleep(0.05)
        self.snap('stopped')


def drive(pkg, scenario, monkeypatch) -> list:
    run = Run(pkg)
    real_delay = pkg.utils.delay

    def delay(*args):
        d = real_delay(*args)
        run.delays.append(d)
        return d
    monkeypatch.setattr(pkg.utils, 'delay', delay)
    try:
        pkg.netsim.run(asyncio.wait_for(scenario(run), 600), seed=SEED)
    finally:
        monkeypatch.undo()
    return run.steps


async def one_then_two_backends(run):
    run.make_set(target=2, maximum=4)
    run.inner.emit('added', 'b1', {})
    await settle()
    run.snap('one backend')
    run.connect_pending()
    await settle()
    run.snap('connected')
    run.inner.emit('added', 'b2', {})
    await settle()
    run.connect_pending()
    await asyncio.sleep(0.1)
    run.snap('two backends')
    await run.stop()


async def swap_to_preferred_backend(run):
    cs = run.make_set(target=1, maximum=1)
    run.inner.emit('added', 'b1', {})
    await settle()
    run.connect_pending()
    await asyncio.sleep(0.1)
    run.snap('b1 in the set')
    run.inner.emit('added', 'b0', {})
    cs.cs_keys.sort()
    await asyncio.sleep(0.2)
    run.snap('b0 building')
    run.connect_pending()
    await asyncio.sleep(0.3)
    run.snap('swapped')
    await run.stop()


async def removing_backends_via_resolver(run):
    cs = run.make_set(target=3, maximum=5)
    for b in ('b1', 'b2', 'b3', 'b4'):
        run.inner.emit('added', b, {})
    cs.cs_keys.sort()
    await settle()
    run.connect_pending()
    await asyncio.sleep(0.2)
    run.snap('three advertised')
    for b in ('b1', 'b2', 'b3'):
        run.inner.emit('removed', b)
    await asyncio.sleep(0.4)
    run.snap('three removed')
    run.connect_pending()
    await asyncio.sleep(0.2)
    run.snap('b4 advertised')
    await run.stop()


async def target_resize(run):
    cs = run.make_set(target=1, maximum=4)
    for b in ('b1', 'b2', 'b3'):
        run.inner.emit('added', b, {})
    await settle()
    run.snap('target 1')
    cs.set_target(3)
    await settle()
    run.connect_pending()
    await asyncio.sleep(0.1)
    run.snap('target 3')
    cs.set_target(1)
    await asyncio.sleep(0.3)
    run.snap('back to 1')
    await run.stop()


async def advertised_connection_dies(run):
    run.make_set(target=2, maximum=4, on_error=True)
    run.inner.emit('added', 'b1', {})
    run.inner.emit('added', 'b2', {})
    await settle()
    run.connect_pending()
    await settle()
    run.snap('both advertised')
    victim = run.conns[run.adverts[1][2]]
    victim.emit('error', RuntimeError('boom'))
    await asyncio.sleep(0.2)
    run.snap('one died')
    await asyncio.sleep(2.0)
    run.snap('retried')
    await run.stop()


async def rebalance_keeps_last_working(run):
    cs = run.make_set(target=2, maximum=5)
    for k in ('b1', 'b2', 'b3', 'b4'):
        run.inner.emit('added', k, {})
    await settle()
    run.connect_pending()
    await asyncio.sleep(0.1)
    run.snap('two advertised')
    cs.cs_keys.reverse()
    cs.rebalance()
    await asyncio.sleep(0.2)
    run.snap('flipped')
    run.connect_pending()
    await asyncio.sleep(0.3)
    run.snap('converged')
    await run.stop()


async def failed_then_recovers(run):
    run.make_set(target=1, maximum=2, retries=0, timeout=300)
    run.inner.emit('added', 'b1', {})
    await settle()
    loop = asyncio.get_running_loop()
    for c in list(run.conns):
        c.connect()
        loop.call_soon(lambda c=c: (c.destroy(), c.emit('close')))
    await asyncio.sleep(0.8)
    run.snap('failed')
    for _ in range(100):
        fresh = [c for c in run.conns if not c.connected and not c.dead]
        if fresh:
            fresh[0].connect()
            break
        await asyncio.sleep(0.05)
    for _ in range(100):
        if run.cset.is_in_state('running'):
            break
        await asyncio.sleep(0.05)
    await settle()
    run.snap('recovered')
    await run.stop()


async def connect_errors_back_off(run):
    run.make_set(target=2, maximum=3, retries=2, timeout=200, delay=50)
    run.inner.emit('added', 'b1', {})
    run.inner.emit('added', 'b2', {})
    await settle()
    for _ in range(6):
        for c in list(run.conns):
            if not c.connected and not c.dead and c.backend == 'b2':
                c.emit('error', ConnectionRefusedError('refused'))
            elif not c.connected and not c.dead:
                c.connect()
        await asyncio.sleep(0.3)
        run.snap('round')
    await run.stop()


async def reshuffle_and_stop_drain(run):
    cs = run.make_set(target=1, maximum=4, release=False)
    for k in ('b1', 'b2', 'b3', 'b4'):
        run.inner.emit('added', k, {})
    await settle()
    run.connect_pending()
    await settle()
    for _ in range(8):
        cs.reshuffle()
    run.snap('reshuffled')
    cs.stop()
    await asyncio.sleep(0.2)
    run.snap('stopping, handles held')
    for c in run.conns:
        c.destroy()
        c.emit('close')
    await asyncio.sleep(0.5)
    run.snap('closed')


SCENARIOS = [one_then_two_backends, swap_to_preferred_backend,
             removing_backends_via_resolver, target_resize,
             advertised_connection_dies, rebalance_keeps_last_working,
             failed_then_recovers, connect_errors_back_off,
             reshuffle_and_stop_drain]


@pytest.mark.parametrize('scenario', SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_connection_set_matches_jax(scenario, monkeypatch):
    want = drive(JAX, scenario, monkeypatch)
    got = drive(PORT, scenario, monkeypatch)
    assert got == want
    assert any(a[0] == 'added' for a in want[-1]['adverts'])


def test_records_see_the_scenario():
    """The record is not trivially equal: another target changes it."""
    async def two(run):
        run.make_set(target=2, maximum=4)
        for b in ('b1', 'b2', 'b3'):
            run.inner.emit('added', b, {})
        await settle()
        run.snap('built')

    async def one(run):
        run.make_set(target=1, maximum=4)
        for b in ('b1', 'b2', 'b3'):
            run.inner.emit('added', b, {})
        await settle()
        run.snap('built')
    mp = pytest.MonkeyPatch()
    assert len(drive(PORT, two, mp)[0]['fsms']) == 2
    assert len(drive(PORT, one, mp)[0]['fsms']) == 1


@pytest.mark.parametrize('options,match', [
    ({'target': 1, 'maximum': 2}, 'recovery.default'),
    ({'recovery': {'default': {'timeout': 1, 'retries': 1, 'delay': 0}},
      'maximum': 2}, 'target'),
])
def test_constructor_validation_matches_jax(options, match):
    msgs = []
    for pkg in (JAX, PORT):
        async def build():
            res = pkg.resolver.ResolverFSM(pkg.events.EventEmitter(), {})
            with pytest.raises(AssertionError) as err:
                pkg.cset.ConnectionSet(dict(
                    {'constructor': lambda b: None, 'resolver': res},
                    **options))
            return str(err.value)
        msgs.append(pkg.netsim.run(build(), seed=SEED))
    assert msgs[0] == msgs[1] and match in msgs[0]
