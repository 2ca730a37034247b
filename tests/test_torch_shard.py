"""The port's shard layer (``cueball_tpu_torch.shard``: ``HashRing``,
``FleetRouter`` and its workers) against the JAX package's, on the CPU.

Each case runs the same steps once over each package's router, with
that package's own pools (``bench._bench_fixture_pool``'s pool, built
from either package's modules), and compares what the two report: the
ring's placements, the pool keys, the snapshots key for key, the
shard-labelled gauges, the claim paths and their errors. The fleet
passes run the port's samplers on the CPU (``device='cpu'``) against
the JAX router's samplers under one frozen clock: counts exactly,
floats to rtol 1e-5, verdicts exactly off
``convert.health_score_near_boundary``. A spawn router runs a port job
in two child processes. Last, the sharded-failover scenario
(``tests/scenarios/test_sharded_failover.py``) through each package's
inline router gives one FSM event trace.
"""

import asyncio
import os
import types

import numpy as np
import pytest

pytest.importorskip('torch')

import cueball_tpu as jcb  # noqa: E402
import cueball_tpu_torch as tcb  # noqa: E402
from cueball_tpu import errors as j_errors  # noqa: E402
from cueball_tpu import events as j_events  # noqa: E402
from cueball_tpu import fsm as j_fsm  # noqa: E402
from cueball_tpu import metrics as j_metrics  # noqa: E402
from cueball_tpu import netsim as j_netsim  # noqa: E402
from cueball_tpu import shard as j_shard  # noqa: E402
from cueball_tpu import trace as j_trace  # noqa: E402
from cueball_tpu import utils as j_utils  # noqa: E402
from cueball_tpu_torch import convert  # noqa: E402
from cueball_tpu_torch import errors as t_errors  # noqa: E402
from cueball_tpu_torch import events as t_events  # noqa: E402
from cueball_tpu_torch import fsm as t_fsm  # noqa: E402
from cueball_tpu_torch import metrics as t_metrics  # noqa: E402
from cueball_tpu_torch import netsim as t_netsim  # noqa: E402
from cueball_tpu_torch import shard as t_shard  # noqa: E402
from cueball_tpu_torch import trace as t_trace  # noqa: E402
from cueball_tpu_torch import utils as t_utils  # noqa: E402

from conftest import run_async, settle, wait_for_state  # noqa: E402

JAX = types.SimpleNamespace(cb=jcb, errors=j_errors, events=j_events,
                            fsm=j_fsm, metrics=j_metrics, netsim=j_netsim,
                            shard=j_shard, trace=j_trace, utils=j_utils,
                            opts={})
PORT = types.SimpleNamespace(cb=tcb, errors=t_errors, events=t_events,
                             fsm=t_fsm, metrics=t_metrics, netsim=t_netsim,
                             shard=t_shard, trace=t_trace, utils=t_utils,
                             opts={'device': 'cpu'})
PACKAGES = (JAX, PORT)
TAPS = 128      # the routers' samplers run the pools' own filter length


def fixture_pool(pkg):
    """``bench.make_fixture()``'s pool over ``pkg``'s modules: one
    backend whose connections connect on the next loop turn."""
    class InstantConnection(pkg.events.EventEmitter):
        def __init__(self, backend):
            super().__init__()
            self.backend = backend
            pkg.fsm.get_loop().call_soon(lambda: self.emit('connect'))

        def destroy(self):
            pass

        def unref(self):
            pass

    class Inner(pkg.events.EventEmitter):
        def __init__(self):
            super().__init__()
            self.backends = {'b1': {'address': '10.0.0.1', 'port': 1}}

        def start(self):
            def emit_all():
                for k, b in self.backends.items():
                    self.emit('added', k, b)
                self.emit('updated')
            pkg.fsm.get_loop().call_soon(emit_all)

        def stop(self):
            pass

        def count(self):
            return len(self.backends)

        def list(self):
            return dict(self.backends)

    def build():
        resolver = pkg.cb.ResolverFSM(Inner(), {})
        resolver.start()
        return pkg.cb.ConnectionPool({
            'domain': 'bench', 'resolver': resolver,
            'constructor': InstantConnection, 'spares': 2, 'maximum': 2,
            'recovery': {'default': {'timeout': 1000, 'retries': 3,
                                     'delay': 100}}})
    return build


async def until_running(pool, timeout=10.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while not pool.is_in_state('running'):
        assert asyncio.get_running_loop().time() < deadline, pool.get_state()
        await asyncio.sleep(0.005)


async def started(pkg, names=(), **options):
    """A started router of ``pkg`` owning the fixture pools ``names``,
    each running."""
    router = pkg.shard.FleetRouter(dict(pkg.opts, **options))
    await router.start()
    for name in names:
        await router.create_pool(name, factory=fixture_pool(pkg))
        await router.submit(name, until_running)
    return router


async def stopped(router):
    for name in list(router.fr_pools):
        await router.destroy_pool(name)
    await router.stop()
    # The JAX router leaves its samplers running; the port's stops them.
    for sampler in router.fr_samplers.values():
        sampler.stop()


# -- the ring and the pool key ----------------------------------------------

@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_ring_assignment_matches_jax(seed):
    """10,000 keys on 1-8 shards, then through an add and a remove,
    land on the same shards in both packages."""
    keys = ['svc-%d.%d' % (seed, i) for i in range(10_000)]
    for n in range(1, 9):
        rings = [pkg.shard.HashRing(n, seed=seed) for pkg in PACKAGES]
        want = rings[0].assignment(keys)
        assert rings[1].assignment(keys) == want
        assert rings[1].shards() == rings[0].shards() == list(range(n))
        for ring in rings:
            ring.add_shard(n + 3)
            ring.remove_shard(0)
        assert rings[1].assignment(keys) == rings[0].assignment(keys)
    assert len(set(want.values())) == 8


@pytest.mark.parametrize('options', [
    None, {'maximum': 4, 'spares': 2}, {'spares': 2, 'maximum': 4},
    {'domain': 'x', 'constructor': fixture_pool, 'ratio': 0.5},
])
def test_pool_key_matches_jax(options):
    want = j_shard.FleetRouter.pool_key('svc', options)
    assert t_shard.FleetRouter.pool_key('svc', options) == want


# -- lifecycle, routing and surfaces ----------------------------------------

def _lifecycle(pkg, backend):
    async def main():
        router = await started(pkg, shards=3, backend=backend, seed=5)
        states = [router.shard_states()]
        snap = router.snapshot()
        active = router in pkg.shard.active_routers()
        await router.stop()
        states.append(router.shard_states())
        return states, snap, active, router in pkg.shard.active_routers()
    return run_async(main(), timeout=20.0)


@pytest.mark.parametrize('backend', ['thread', 'inline'])
def test_lifecycle_matches_jax(backend):
    want = _lifecycle(JAX, backend)
    assert _lifecycle(PORT, backend) == want
    assert want[0] == [{0: 'running', 1: 'running', 2: 'running'},
                       {0: 'stopped', 1: 'stopped', 2: 'stopped'}]
    assert want[2:] == (True, False)


def _routed(pkg, backend):
    """Routed claims and releases, a batch, the errors of an unknown
    pool, then the snapshot: the record both packages must give."""
    names = ['svc.r%d' % i for i in range(6)]

    async def main():
        router = await started(pkg, names, shards=2, backend=backend)
        out = {'shards': {n: router.shard_of(n) for n in names},
               'p_shard': {n: router.get_pool(n).p_shard for n in names}}
        claims = []
        for name in names:
            claim = await router.claim(name)
            assert isinstance(claim, pkg.shard.RoutedClaim)
            assert claim.connection is not None
            claims.append((claim.rc_name, claim.rc_shard,
                           claim.handle.get_state()))
            await claim.release()
        batch = await router.claim_many(names[0], 2)
        claims.append([rc.handle.get_state() for rc in batch])
        await router.release_many(batch)
        again = await router.claim(names[0])
        await again.release()
        out['claims'] = claims
        with pytest.raises(KeyError) as err:
            await router.claim('nope')
        out['unknown'] = str(err.value)
        out['snapshot'] = router.snapshot()
        await stopped(router)
        return out
    return run_async(main(), timeout=20.0)


@pytest.mark.parametrize('backend', ['thread', 'inline'])
def test_routed_claims_and_snapshot_match_jax(backend):
    want = _routed(JAX, backend)
    got = _routed(PORT, backend)
    assert got == want
    assert want['shards'] == want['p_shard']
    assert set(want['shards'].values()) == {0, 1}
    assert set(want['snapshot']) == {'backend', 'nshards', 'seed', 'states',
                                     'submits', 'pools'}


def _claim_cb(pkg, backend):
    async def main():
        router = await started(pkg, ['svc.cb'], shards=1, backend=backend)
        caller = asyncio.get_running_loop()
        done = asyncio.Event()
        seen = {}

        def cb(err, hdl=None, conn=None):
            seen.update(err=err, hdl=hdl,
                        on_caller=asyncio.get_running_loop() is caller)
            done.set()

        direct = router.claim_cb('svc.cb', {}, cb)
        await asyncio.wait_for(done.wait(), 10.0)
        await router.submit('svc.cb', lambda _pool: seen['hdl'].release())
        await stopped(router)
        return {'returned_handle': direct is not None,
                'err': seen['err'], 'on_caller': seen['on_caller']}
    return run_async(main(), timeout=20.0)


@pytest.mark.parametrize('backend', ['thread', 'inline'])
def test_claim_cb_marshalling_matches_jax(backend):
    """Cross-loop the claim posts to the shard, returns None and the
    callback comes back on the caller's loop; inline it is a direct
    ``pool.claim_cb`` returning the handle."""
    want = _claim_cb(JAX, backend)
    assert _claim_cb(PORT, backend) == want
    assert want == {'returned_handle': backend == 'inline', 'err': None,
                    'on_caller': True}


def _dead_shard(pkg):
    async def main():
        router = await started(pkg, ['svc.dead'], shards=1,
                               backend='thread')
        rec = router.fr_pools['svc.dead']
        old_pool = rec.pool

        async def hang(_pool):
            await asyncio.sleep(60)

        pending = asyncio.ensure_future(router.submit('svc.dead', hang))
        await settle(20)
        router.fr_workers[rec.shard_id].request_stop()
        errors = []
        with pytest.raises(pkg.errors.ShardDeadError) as err:
            await asyncio.wait_for(pending, 5.0)
        errors.append(str(err.value))
        for attempt in (lambda: router.claim('svc.dead'),
                        lambda: router.run_on(0, lambda: None)):
            with pytest.raises(pkg.errors.ShardDeadError) as err:
                await attempt()
            errors.append(str(err.value))
        with pytest.raises(pkg.errors.ShardDeadError) as err:
            router.claim_cb('svc.dead', {}, lambda *a: None)
        errors.append(str(err.value))
        await wait_for_state(router.fr_fsms[0], 'failed', timeout=5.0)
        states = [router.shard_states()]
        await router.restart_shard(0)
        states.append(router.shard_states())
        claim = await router.claim('svc.dead')
        rebuilt = rec.pool is not None and rec.pool is not old_pool
        await claim.release()
        await stopped(router)
        with pytest.raises(pkg.errors.CueBallError) as err:
            await router.restart_shard(0)
        errors.append(str(err.value))
        return errors, states, rebuilt
    return run_async(main(), timeout=20.0)


# Killing the loop strands the in-flight job's coroutine by design; the
# warning it emits on GC is the scenario under test.
@pytest.mark.filterwarnings('ignore::RuntimeWarning')
def test_dead_shard_then_restart_matches_jax():
    """A job in flight on a dying shard gets ShardDeadError, new routed
    work fails fast, the watchdog fails the shard, and restart_shard
    rebuilds its pools: the same errors and states in both packages."""
    want = _dead_shard(JAX)
    assert _dead_shard(PORT) == want
    assert want[1] == [{0: 'failed'}, {0: 'running'}] and want[2]


def _gauges(pkg):
    async def main():
        router = await started(pkg, ['svc.m0', 'svc.m1', 'svc.m2'],
                               shards=2, backend='thread')
        coll = pkg.metrics.create_collector()
        router.attach_metrics(coll)
        with pytest.raises(pkg.errors.CueBallError):
            router.attach_metrics(coll)
        lines = sorted(ln for ln in coll.collect().splitlines()
                       if ln.startswith('cueball_shard_'))
        await stopped(router)
        return lines, router.fr_collector is None
    return run_async(main(), timeout=20.0)


def test_shard_gauges_match_jax():
    want = _gauges(JAX)
    assert _gauges(PORT) == want
    assert 'cueball_shard_up{shard="1"} 1' in want[0] and want[1]


# -- the fleet passes -------------------------------------------------------

class FrozenClock:
    def __init__(self):
        self.t = j_utils.current_millis()

    def advance(self, ms):
        self.t += ms

    def __call__(self):
        return self.t


@pytest.fixture
def frozen():
    """One frozen clock for both packages' ``utils.current_millis``."""
    saved = (j_utils.current_millis, t_utils.current_millis)
    clock = FrozenClock()
    j_utils.current_millis = t_utils.current_millis = clock
    try:
        yield clock
    finally:
        j_utils.current_millis, t_utils.current_millis = saved


POOLS = ['svc.fl%d' % i for i in range(6)]


def assert_rows_agree(got: dict, want: dict, tag):
    """A reduced row against the JAX one: the same keys, counts and
    flags exactly, floats to rtol 1e-5."""
    assert set(got) == set(want), tag
    for key, v in want.items():
        if isinstance(v, (bool, int, list)) or key == 'n_pools':
            assert got[key] == v, (tag, key)
        else:
            assert got[key] == pytest.approx(v, rel=1e-5, abs=1e-5), (
                tag, key)


async def both_routers():
    """A started 2-shard thread router of each package over the same
    pool names (so on the same shards)."""
    routers = [await started(pkg, POOLS, shards=2, backend='thread')
               for pkg in PACKAGES]
    assert routers[0].snapshot() == routers[1].snapshot()
    return routers


def test_sample_fleet_matches_jax(frozen):
    async def main():
        jr, tr = await both_routers()
        try:
            for tick in range(3):
                frozen.advance(200)
                want = await jr.sample_fleet()
                got = await tr.sample_fleet()
                assert want['n_pools'] == len(POOLS)
                assert_rows_agree(got, want, tick)
            assert sorted(tr.fr_samplers) == [0, 1]
            assert tr.fr_samplers is tr.fr_runtime.rt_samplers
            assert all(str(s.fs_device) == 'cpu'
                       for s in tr.fr_samplers.values())
        finally:
            for r in (jr, tr):
                await stopped(r)
        assert tr.fr_samplers == {}
    run_async(main(), timeout=60.0)


def _health_edge(got, want):
    """Backends whose JAX score lies on its rounding boundary; verdicts
    equal elsewhere."""
    edge = 0
    for key, wb in want['backends'].items():
        gb = got['backends'][key]
        assert gb['ewma_ms'] == pytest.approx(wb['ewma_ms'], rel=1e-5)
        if convert.health_score_near_boundary(np.float32(wb['ewma_ms'])):
            edge += 1
            continue
        assert (gb['gray'], gb['score']) == (wb['gray'], wb['score']), key
    return edge


def test_health_fleet_and_snapshot_match_jax(frozen):
    async def main():
        jr, tr = await both_routers()
        try:
            frozen.advance(1000)
            assert_rows_agree(await tr.health_fleet(),
                              await jr.health_fleet(), 'first')
            sinks = [pkg.trace._BACKEND_SINKS for pkg in PACKAGES]
            rng = np.random.default_rng(45)
            edge = 0
            for tick in range(5):
                for _ in range(60):
                    key = 'be-sh-%d' % rng.integers(0, 8)
                    ms = float(rng.uniform(1, 8)) * (
                        30.0 if key == 'be-sh-3' else 1.0)
                    ok = bool(rng.random() < 0.97)
                    for sink in sinks[0] + sinks[1]:
                        sink.observe(key, ms if ok else None, ms + 1.0, ok)
                frozen.advance(1000)
                want = await jr.health_fleet()
                got = await tr.health_fleet()
                for sid in (0, 1):
                    edge += _health_edge(
                        tr.fr_samplers[sid].fs_health_monitor.hm_last,
                        jr.fr_samplers[sid].fs_health_monitor.hm_last)
                if not edge:
                    assert_rows_agree(got, want, tick)
            assert edge == 0
            assert want['ops'] == 2 * 60       # each shard sees every claim
            assert want['gray'] == got['gray'] == ['be-sh-3']
            jsnap, tsnap = jr.snapshot(), tr.snapshot()
            assert_rows_agree(tsnap.pop('health'), jsnap.pop('health'),
                              'snapshot')
            assert tsnap == jsnap
        finally:
            for r in (jr, tr):
                await stopped(r)
    run_async(main(), timeout=60.0)


def test_control_fleet_matches_jax(frozen):
    """Control passes past the warm-up, so decisions reach the pools;
    each package's router samples only its own package's pools, so the
    two run side by side."""
    async def main():
        jr, tr = await both_routers()
        try:
            rows = []
            for _ in range(TAPS + 3):
                frozen.advance(200)
                rows.append((await tr.control_fleet(),
                             await jr.control_fleet()))
            for tick, (got, want) in enumerate(rows):
                assert_rows_agree(got, want, tick)
            epochs = [[p.p_ctrl_epoch for p in
                       (r.get_pool(n) for n in POOLS)] for r in (jr, tr)]
        finally:
            for r in (jr, tr):
                await stopped(r)
        assert epochs[0] == epochs[1]
        assert rows[-1][1]['applied'] + rows[-1][1]['rejected'] > 0
        assert rows[0][1]['applied'] + rows[0][1]['rejected'] == 0
    run_async(main(), timeout=90.0)


def test_router_samplers_default_to_the_card():
    """No ``device`` option: the shard samplers' default is CUDA, and
    without a card the first pass raises; the router still stops."""
    async def main():
        router = t_shard.FleetRouter({'shards': 1, 'backend': 'inline'})
        await router.start()
        try:
            with pytest.raises(RuntimeError, match='CUDA'):
                await router.sample_fleet()
            assert router.fr_samplers == {}
        finally:
            await router.stop()
    if __import__('torch').cuda.is_available():
        pytest.skip('a CUDA card is present')
    run_async(main(), timeout=20.0)


# -- the spawn backend ------------------------------------------------------

def test_spawn_children_run_port_jobs_and_refuse_the_passes():
    """Two spawn children each run ``cueball_tpu_torch.shard.proc:_ping``
    (distinct pids, neither ours); every fleet pass is refused with the
    JAX router's message."""
    async def main():
        router = t_shard.FleetRouter({'shards': 2, 'backend': 'spawn'})
        jrouter = j_shard.FleetRouter({'shards': 2, 'backend': 'spawn'})
        await router.start(timeout_s=30.0)
        try:
            pings = [await router.run_on(
                sid, 'cueball_tpu_torch.shard.proc:_ping')
                for sid in (0, 1)]
            for name in ('sample_fleet', 'control_fleet', 'health_fleet'):
                with pytest.raises(j_errors.CueBallError) as want:
                    await getattr(jrouter, name)()
                with pytest.raises(t_errors.CueBallError) as got:
                    await getattr(router, name)()
                assert str(got.value) == str(want.value)
            with pytest.raises(t_errors.CueBallError, match='spawn'):
                await router.profile_fleet()
        finally:
            await router.stop()
        assert router.fr_samplers == {}
        return pings
    pings = run_async(main(), timeout=15.0)
    assert [p['shard'] for p in pings] == [0, 1]
    assert len({p['pid'] for p in pings} | {os.getpid()}) == 3


# -- the sharded-failover scenario ------------------------------------------

RECOVERY = {'default': {'retries': 2, 'timeout': 500, 'delay': 100,
                        'maxDelay': 400, 'delaySpread': 0.2}}


def _routed_arm(pkg, seed):
    """``test_sharded_failover._run_arm(seed, sharded=True)`` over
    ``pkg``: a pool owned by a shard of a 4-shard inline router through
    a regional partition, its heal and a CoDel overload burst, claimed
    through ``router.claim_cb``. Returns the scenario's records."""
    fabric = pkg.netsim.Fabric()
    sc = pkg.netsim.Scenario('sharded-failover', seed=seed)
    result = {}

    async def claim_release(claim_fn):
        fut = asyncio.get_running_loop().create_future()

        def cb(err, hdl=None, conn=None):
            if not fut.done():
                fut.set_result((err, hdl))
        claim_fn({}, cb)
        err, hdl = await fut
        if err is not None:
            return False
        hdl.release()
        return True

    async def main():
        loop = asyncio.get_running_loop()
        backends = [{'address': '10.%d.0.%d' % (r, b), 'port': 80}
                    for r in (1, 2, 3) for b in (1, 2, 3)]

        def build():
            res = pkg.cb.StaticIpResolver({'backends': backends})
            pool = pkg.cb.ConnectionPool({
                'domain': 'svc.sim', 'constructor': fabric.constructor,
                'resolver': res, 'spares': 3, 'maximum': 9,
                'recovery': RECOVERY, 'targetClaimDelay': 150.0})
            res.start()
            return pool, res

        router = pkg.shard.FleetRouter({'shards': 4, 'backend': 'inline'})
        await router.start()
        try:
            await asyncio.sleep(1.0 - loop.time())
            rec = await router.create_pool('svc.sim', factory=build)
            pool, res = rec.pool, rec.aux[0]
            result['shard_id'] = rec.shard_id

            def claim_fn(opts, cb):
                return router.claim_cb('svc.sim', opts, cb)
            while not pool.is_in_state('running'):
                await asyncio.sleep(0.05)
            region1 = [k for k in pool.p_keys
                       if pool.p_backends[k]['address'].startswith('10.1.')]
            sc.at(5.0, 'partition-r1', lambda: fabric.partition(region1))
            sc.at(25.0, 'heal-r1', lambda: fabric.heal())
            while loop.time() < 4.5:
                assert await claim_release(claim_fn)
                await asyncio.sleep(0.25)
            while loop.time() < 5.01:
                await asyncio.sleep(0.05)
            t0, streak = loop.time(), 0
            while streak < 3:
                streak = streak + 1 if await claim_release(claim_fn) else 0
                await asyncio.sleep(0.1)
            result['recovery_s'] = loop.time() - t0
            failures = 0
            while loop.time() < 24.5:
                failures += not await claim_release(claim_fn)
                await asyncio.sleep(0.25)
            result['mid_partition_failures'] = failures
            deadline = loop.time() + 30.0
            while loop.time() < deadline and pool.p_dead:
                await asyncio.sleep(0.5)
            result['dead_after_heal'] = sorted(pool.p_dead)
            while loop.time() < 58.0:
                await asyncio.sleep(0.1)
            pending = [0]

            def make_claim():
                pending[0] += 1

                def cb(err, hdl=None, conn=None):
                    if err is None:
                        loop.call_later(0.05, hdl.release)
                    pending[0] -= 1
                claim_fn({}, cb)
            deadline = loop.time() + 3.0
            while loop.time() < deadline:
                for _ in range(4):
                    make_claim()
                await asyncio.sleep(0.01)
            while pending[0] > 0:
                await asyncio.sleep(0.05)
            result['codel_sheds'] = pool.get_stats()['counters'].get(
                'codel-paced-drop', 0)
            pool.stop()
            while not pool.is_in_state('stopped'):
                await asyncio.sleep(0.05)
            res.stop()
            await asyncio.sleep(0.2)
        finally:
            await router.stop()

    sc.run(lambda: main())
    result['fired'] = [label for _, label in sc.fired]
    result['trace'] = list(sc.trace)
    return result


@pytest.mark.parametrize('seed', [7, 1234])
def test_sharded_scenario_trace_matches_jax(seed):
    """The same seeded schedule through each package's inline router:
    the FSM transition traces (the routers' ShardFSMs among them), the
    recovery clock and the CoDel sheds are equal."""
    want = _routed_arm(JAX, seed)
    got = _routed_arm(PORT, seed)
    assert got == want
    assert want['fired'] == ['partition-r1', 'heal-r1']
    assert want['codel_sheds'] > 0 and len(want['trace']) > 100
    assert sum(cls == 'ShardFSM' for cls, _, _ in want['trace']) > 0
