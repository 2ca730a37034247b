"""The port's fleet passes (``shard.FleetRuntime``) against the JAX
package's ``FleetRouter`` passes, on the CPU.

A real ``cueball_tpu.shard.FleetRouter`` with the thread backend owns
small pools (``bench._bench_fixture_pool``) on two shard loops, under
a frozen clock. Its own ``sample_fleet``, ``health_fleet`` and
``snapshot()['health']`` and a ``FleetRuntime`` over it (port samplers
on the CPU, reading the JAX package's host state through
``host.seam_over``) give the same rows: counts exactly, floats to rtol
1e-5, verdicts exactly off ``convert.health_score_near_boundary``.
``control_fleet`` mutates pools past the warm-up, so it runs on twin
routers built alike, one after the other (both would sample each
other's pools through the process-wide pool monitor if they ran at
once). The spawn refusal, the no-fallback rule and the stop run over
duck-typed routers; ``entry.ShardedWorkload`` is held against one
sampler over the same pools.
"""

import asyncio
import contextlib
import types

import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')

from bench import _bench_fixture_pool, settle  # noqa: E402
from cueball_tpu import trace as mod_trace  # noqa: E402
from cueball_tpu.errors import CueBallError as JCueBallError  # noqa: E402
from cueball_tpu.monitor import pool_monitor  # noqa: E402
from cueball_tpu.shard import FleetRouter  # noqa: E402
from cueball_tpu_torch import convert  # noqa: E402
from cueball_tpu_torch.entry import ShardedWorkload  # noqa: E402
from cueball_tpu_torch.errors import CueBallError  # noqa: E402
from cueball_tpu_torch.parallel.control import PRESSURE_HOT  # noqa: E402
from cueball_tpu_torch.parallel.control import PRESSURE_IDLE  # noqa: E402
from cueball_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from cueball_tpu_torch.parallel.sampler import (FleetSampler,  # noqa: E402
                                                reduce_fleet)
from cueball_tpu_torch.shard import FleetRuntime  # noqa: E402

from conftest import run_async  # noqa: E402
from test_torch_health import jax_host  # noqa: E402
from test_torch_sampler import frozen_clock  # noqa: E402,F401

CPU = 'cpu'
POOLS = ['svc.tr%d' % i for i in range(6)]
TAPS = 128      # the router's samplers run the pools' own filter length


@contextlib.asynccontextmanager
async def routed(names=POOLS):
    """A started 2-shard thread router owning ``names`` (both shards own
    some), and a FleetRuntime over it on the CPU; both torn down after,
    the JAX router's samplers stopped too."""
    router = FleetRouter({'shards': 2, 'backend': 'thread'})
    await router.start()
    rt = None
    try:
        for name in names:
            await router.create_pool(name, factory=_bench_fixture_pool)
            await router.submit(name, settle)
        assert {router.fr_pools[n].shard_id for n in names} == {0, 1}
        rt = FleetRuntime(router, {'device': CPU, 'monitor': pool_monitor,
                                   'host': jax_host()})
        yield router, rt
    finally:
        if rt is not None:
            await rt.stop()
        for sampler in router.fr_samplers.values():
            sampler.stop()
        for name in names:
            if name in router.fr_pools:
                await router.destroy_pool(name)
        await router.stop()


def assert_rows_agree(got: dict, want: dict, tag):
    """A reduced row against the JAX one: the same keys, counts and
    flags exactly, floats to rtol 1e-5."""
    assert set(got) == set(want), tag
    for key, v in want.items():
        g = got[key]
        if isinstance(v, (bool, int, list)) or key == 'n_pools':
            assert g == v, (tag, key)
        else:
            assert g == pytest.approx(v, rel=1e-5, abs=1e-5), (tag, key)


def test_sample_fleet_matches_router(frozen_clock):  # noqa: F811
    async def t():
        async with routed() as (router, rt):
            for tick in range(3):
                frozen_clock.advance(200)
                want = await router.sample_fleet()
                got = await rt.sample_fleet()
                assert want['n_pools'] >= len(POOLS)
                assert_rows_agree(got, want, tick)
            # One port sampler per shard, kept by the runtime alone.
            assert sorted(rt.rt_samplers) == [0, 1]
            assert all(s.fs_shard == sid
                       for sid, s in rt.rt_samplers.items())
            assert not any(s in router.fr_samplers.values()
                           for s in rt.rt_samplers.values())
            # The sample pass goes through fr_workers[sid].run, which
            # counts no submit, as the router's own pass.
            submits = dict(router.fr_submits)
            await rt.sample_fleet()
            assert router.fr_submits == submits
    run_async(t(), timeout=120.0)


def test_sample_fleet_over_a_mesh_matches_router(frozen_clock):  # noqa: F811
    """host -> mesh: the shard rows reduce over a 2x4 mesh, the JAX
    router's over the tests' eight virtual devices, the port's over
    eight CPU shards; the port's equals its flat reduce of the same
    rows."""
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                              ('host', 'chip'))
    tmesh = Mesh(np.array([CPU] * 8, dtype=object).reshape(2, 4),
                 ('host', 'chip'))

    async def t():
        async with routed() as (router, rt):
            for tick in range(2):
                frozen_clock.advance(200)
                want = await router.sample_fleet(mesh=jmesh)
                got = await rt.sample_fleet(mesh=tmesh)
                assert_rows_agree(got, want, tick)
                flat = reduce_fleet([s.fs_latest['fleet'] for _, s in
                                     sorted(rt.rt_samplers.items())])
                assert_rows_agree(got, flat, tick)
    run_async(t(), timeout=120.0)


def _assert_health_records_agree(got: dict, want: dict, tag):
    """One shard's health record against the JAX shard's: verdicts
    exactly off the score's rounding boundary, floats to rtol 1e-5."""
    assert (got['epoch'], got['at_ms']) == (want['epoch'], want['at_ms'])
    assert sorted(got['backends']) == sorted(want['backends']), tag
    edge = 0
    for key, wb in want['backends'].items():
        gb = got['backends'][key]
        assert gb['ewma_ms'] == pytest.approx(wb['ewma_ms'], rel=1e-5)
        if convert.health_score_near_boundary(np.float32(wb['ewma_ms'])):
            edge += 1
            continue
        assert (gb['gray'], gb['score']) == (wb['gray'], wb['score']), (
            tag, key)
    if not edge:
        assert got['gray'] == want['gray'], tag
    return edge


def test_health_fleet_and_snapshot_match_router(frozen_clock):  # noqa: F811
    async def t():
        async with routed() as (router, rt):
            assert rt.health_snapshot() is None
            frozen_clock.advance(1000)
            # The first pass makes each shard's monitor, whose table
            # joins the trace layer's sinks: claims come after it.
            assert_rows_agree(await rt.health_fleet(),
                              await router.health_fleet(), 'first')
            tables = [s.fs_health_monitor.hm_table for s in
                      (*router.fr_samplers.values(),
                       *rt.rt_samplers.values())]
            rng = np.random.default_rng(44)
            edge = 0
            for tick in range(6):
                for _ in range(60):
                    key = 'be-rt-%d' % rng.integers(0, 8)
                    ms = float(rng.uniform(1, 8)) * (
                        30.0 if key == 'be-rt-3' else 1.0)
                    ok = bool(rng.random() < 0.97)
                    for sink in mod_trace._BACKEND_SINKS:
                        if sink in tables:
                            sink.observe(key, ms if ok else None, ms + 1.0,
                                         ok)
                frozen_clock.advance(1000)
                want = await router.health_fleet()
                got = await rt.health_fleet()
                for sid in (0, 1):
                    edge += _assert_health_records_agree(
                        rt.rt_samplers[sid].fs_health_monitor.hm_last,
                        router.fr_samplers[sid].fs_health_monitor.hm_last,
                        (tick, sid))
                if not edge:
                    assert_rows_agree(got, want, tick)
            assert edge == 0
            # Every shard's table sees every claim: ops is twice the
            # claims, as on the router.
            assert want['ops'] == 2 * 60
            assert want['gray'] == got['gray'] == ['be-rt-3']
            assert_rows_agree(rt.health_snapshot(),
                              router.snapshot()['health'], 'snapshot')
    run_async(t(), timeout=120.0)


def test_control_fleet_matches_router_on_twins(frozen_clock):  # noqa: F811
    """Control passes past the warm-up, so decisions reach the pools:
    the JAX router's passes on one router, the runtime's on its twin
    (built alike, from the same clock instant)."""
    passes = TAPS + 3

    async def run(use_port):
        start = frozen_clock.t
        rows = []
        async with routed() as (router, rt):
            for _ in range(passes):
                frozen_clock.advance(200)
                rows.append(await (rt.control_fleet() if use_port
                                   else router.control_fleet()))
        frozen_clock.t = start
        return rows

    async def t():
        want = await run(False)
        got = await run(True)
        for tick, (g, w) in enumerate(zip(got, want)):
            assert_rows_agree(g, w, tick)
        # Past the warm-up the pools were offered decisions.
        assert want[-1]['applied'] + want[-1]['rejected'] > 0
        assert want[0]['applied'] + want[0]['rejected'] == 0
    run_async(t(), timeout=120.0)


class _DuckRouter:
    """The router surface FleetRuntime reads, over one thread loop per
    shard (``entry.ShardedWorkload``'s workers), with a chosen
    backend."""

    def __init__(self, backend='thread', n=2):
        self.work = ShardedWorkload(n, 8)
        self.fr_backend = backend
        self.fr_fsms = self.work.fr_fsms
        self.fr_workers = self.work.fr_workers
        self.run_on = self.work.run_on


@pytest.mark.parametrize('name', ['sample_fleet', 'control_fleet',
                                  'health_fleet'])
def test_spawn_backend_refuses_each_pass(name):
    """The JAX router's refusals, message for message; no shard job
    runs (the spawn router is never started)."""
    jrouter = FleetRouter({'shards': 1, 'backend': 'spawn'})
    rt = FleetRuntime(types.SimpleNamespace(
        fr_backend='spawn', fr_fsms={}, fr_workers={}), {'device': CPU})

    async def t():
        with pytest.raises(JCueBallError) as want:
            await getattr(jrouter, name)()
        with pytest.raises(CueBallError) as got:
            await getattr(rt, name)()
        assert str(got.value) == str(want.value)
        assert rt.rt_samplers == {}
    run_async(t())


def test_a_failing_shard_fails_the_pass():
    """No fallback: a job that raises on one shard's loop raises out of
    the pass; a shard that returns no record fails it too."""
    duck = _DuckRouter()
    rt = FleetRuntime(duck, duck.work.options(device=CPU))

    def boom(shard_id):
        if shard_id == 1:
            raise RuntimeError('shard 1 kernel failed')
        return rt._sampler(shard_id).sample_once()['fleet']

    async def t():
        rt._sample_shard = boom
        with pytest.raises(RuntimeError, match='shard 1 kernel failed'):
            await rt.sample_fleet()
        assert rt.rt_samplers[0].fs_ticks == 1
        rt._control_shard = lambda shard_id: None
        with pytest.raises(CueBallError, match='returned no record'):
            await rt.control_fleet()
        await rt.stop()
    try:
        run_async(t())
    finally:
        duck.work.close()


def test_stop_stops_each_sampler_on_its_loop():
    duck = _DuckRouter()
    rt = FleetRuntime(duck, duck.work.options(device=CPU))
    stopped_on = {}

    async def t():
        duck.work.advance()
        await rt.health_fleet()
        for sid, sampler in rt.rt_samplers.items():
            stop = sampler.stop

            def record(stop=stop, sid=sid):
                stopped_on[sid] = asyncio.get_running_loop()
                stop()
            sampler.stop = record
        monitors = [s.fs_health_monitor for s in rt.rt_samplers.values()]
        assert all(m.hm_started for m in monitors)
        await rt.stop()
        assert rt.rt_samplers == {} and rt.health_snapshot() is None
        assert not any(m.hm_started for m in monitors)
    try:
        run_async(t())
    finally:
        duck.work.close()
    assert stopped_on == {sid: duck.fr_workers[sid].loop for sid in (0, 1)}


def test_sharded_workload_decisions_equal_one_sampler():
    """FleetRuntime over ShardedWorkload(2, 32) against one FleetSampler
    over the same 64 pools: every pool's decisions are identical. Each
    shard's control step reads its own pressure; on this workload both
    shards' pressure and the fleet's sit in the same band (neither
    quiet nor hot), which the test asserts, so the decisions agree."""
    work = ShardedWorkload(2, 32)
    rt = FleetRuntime(work, work.options(device=CPU))
    whole = FleetSampler(work.options(device=CPU))

    def band(p):
        return (p < PRESSURE_IDLE, p >= PRESSURE_HOT)

    async def t():
        for tick in range(6):
            work.advance()
            await rt.control_fleet()
            want = whole.sample_once()['control']
            for sid, sampler in rt.rt_samplers.items():
                got = sampler.fs_latest['control']
                assert band(got['fleet']['pressure']) == band(
                    want['fleet']['pressure']), (tick, sid)
                for uuid, row in sampler.fs_rows.items():
                    wrow = whole.fs_rows[uuid]
                    for name, col in want['decisions'].items():
                        g = got['decisions'][name]
                        if col.ndim:
                            assert g[row] == col[wrow], (tick, uuid, name)
                        else:
                            assert g == col, (tick, name)
        assert want['fleet']['pressure'] > 0.0
        await rt.stop()
        whole.stop()
    try:
        run_async(t())
    finally:
        work.close()
