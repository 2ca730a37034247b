"""The PyTorch port's FleetSampler over a mesh, on the CPU.

The cases of tests/test_sampler_mesh.py, on a port ``Mesh`` of eight
``cpu`` shards (1-D ('pools',), and a 2-D ('host', 'chip') 2x4 one),
held against a JAX mesh sampler over the eight virtual CPU devices that
``conftest`` forces and against the port's plain sampler. The clock is
frozen and advanced by hand, and the port samplers read the JAX
package's process state through the ``host`` seam, so all of them see
the same instant.

Against the port's plain sampler, on the same CPU, the per-pool
outputs and decisions agree exactly (the laws are elementwise and the
FIR works row by row); the float fleet aggregates, summed in another
order, to rtol 1e-5 / atol 1e-5. Against the JAX mesh sampler the
tolerances of tests/test_torch_sampler.py hold: floats rtol 1e-5 /
atol 1e-5, `drop` exactly, `target`, `clamped` and the plans exactly
off ``convert.target_near_boundary``.

Donation has no counterpart in the port: each shard ping-pongs its own
window ring, which the tests check in its place.
"""

import asyncio

import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')

from jax.sharding import Mesh as JMesh  # noqa: E402

from cueball_tpu import trace as mod_trace  # noqa: E402
from cueball_tpu.monitor import PoolMonitor  # noqa: E402
from cueball_tpu.parallel import sampler as jsampler  # noqa: E402
from cueball_tpu_torch.parallel import sampler as tsampler  # noqa: E402
from cueball_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from cueball_tpu_torch.parallel.sampler import FleetSampler  # noqa: E402

from conftest import run_async, settle  # noqa: E402
from test_pool import Ctx, claim, make_pool  # noqa: E402
from test_torch_health import jax_host  # noqa: E402
from test_torch_sampler import (  # noqa: E402,F401 (frozen_clock: fixture)
    FakePool, assert_records_agree, frozen_clock)

CPU = 'cpu'


@pytest.fixture(scope='module')
def meshes():
    """name -> (JAX mesh, port mesh, axes)."""
    devs = np.array(jax.devices()[:8])
    assert devs.size == 8, 'conftest should have forced 8 CPU devices'
    out = {}
    for name, axes, shape in (('1d', ('pools',), (8,)),
                              ('2d', ('host', 'chip'), (2, 4))):
        out[name] = (JMesh(devs.reshape(shape), axes),
                     Mesh(np.array([CPU] * 8, dtype=object).reshape(shape),
                          axes), axes)
    return out


def port_sampler(mon, mesh=None, axes=('pools',), **opts):
    if mesh is not None:
        opts.update(mesh=mesh, meshAxes=axes)
    return FleetSampler({'monitor': mon, 'record': True, 'device': CPU,
                         'host': jax_host(), **opts})


def assert_same_as_plain(got, want, tag):
    """The mesh sampler's record against the plain port sampler's: every
    input, row, per-pool output and decision exactly; the float fleet
    aggregates to rtol 1e-5 / atol 1e-5."""
    assert got['pools'].keys() == want['pools'].keys(), tag
    for uuid, w in want['pools'].items():
        assert got['pools'][uuid] == w, (tag, uuid)
    for key, v in want['fleet'].items():
        assert got['fleet'][key] == pytest.approx(v, rel=1e-5, abs=1e-5), (
            tag, key)
    if 'control' in want:
        for key, v in want['control']['decisions'].items():
            np.testing.assert_array_equal(got['control']['decisions'][key],
                                          v, err_msg='%s %s' % (tag, key))
    if 'health' in want:
        assert got['health'] == want['health'], tag


def assert_like_jax(got, want, tag):
    """The port mesh sampler's record against the JAX mesh sampler's
    (no control or health planes)."""
    assert set(got['pools']) == set(want['pools']), tag
    for uuid, w in want['pools'].items():
        g = got['pools'][uuid]
        assert g['inputs'] == w['inputs'] and g['row'] == w['row'], (
            tag, uuid)
        for key in ('filtered', 'target', 'retry_backoff'):
            assert g[key] == pytest.approx(w[key], rel=1e-5, abs=1e-5), (
                tag, uuid, key)
        assert (g['drop'], g['clamped']) == (w['drop'], w['clamped']), (
            tag, uuid)
    for key, v in want['fleet'].items():
        assert got['fleet'][key] == pytest.approx(v, rel=1e-5, abs=1e-5), (
            tag, key)


def test_mesh_sampler_matches_jax_and_plain_on_live_pools(frozen_clock,
                                                          meshes):
    jmesh, mesh, _ = meshes['1d']

    async def t():
        ctx = Ctx()
        pool_a, inner_a = make_pool(ctx, spares=2, maximum=2,
                                    targetClaimDelay=300)
        pool_b, inner_b = make_pool(ctx, spares=3, maximum=6)
        inner_a.emit('added', 'a1', {})
        inner_b.emit('added', 'b1', {})
        inner_b.emit('added', 'b2', {})
        await settle()
        for c in list(ctx.connections):
            c.connect()
        await settle()
        mon = PoolMonitor()
        for p in (pool_a, pool_b):
            mon.register_pool(p)
        meshed = port_sampler(mon, mesh)
        plain = port_sampler(mon)
        jmeshed = jsampler.FleetSampler({'monitor': mon, 'record': True,
                                         'mesh': jmesh})
        # The JAX sampler's first tick compiles for seconds of real time;
        # tick once before the claims start.
        assert_like_jax(meshed.sample_once(), jmeshed.sample_once(), 'warm')
        plain.sample_once()
        held = []
        for _ in range(2):
            fut, _ = claim(pool_a)
            held.append(await fut)
        queued = [claim(pool_a) for _ in range(3)]
        for tick in range(12):
            await settle(2)
            frozen_clock.advance(20)
            rec_j = jmeshed.sample_once()
            rec_m = meshed.sample_once()
            assert_same_as_plain(rec_m, plain.sample_once(), tick)
            assert_like_jax(rec_m, rec_j, tick)
            if tick % 7 == 3 and held:
                hdl, _ = held.pop()
                hdl.release()
        # Queued claims produced sojourns, and the state lives on every
        # shard.
        assert any(r['pools'][pool_a.p_uuid]['inputs']['sojourn'] > 0
                   for r in meshed.fs_history)
        assert len(meshed.fs_state) == 8
        assert {s.windows.shape for s in meshed.fs_state} == {(1, 128)}
        for fut, waiter in queued:
            if not fut.done():
                waiter.cancel()
        for hdl, _ in held:
            hdl.release()
        pool_a.stop()
        pool_b.stop()
        await settle(30)
    run_async(t())


def test_2d_mesh_sampler_matches_jax_and_plain(meshes):
    jmesh, mesh, axes = meshes['2d']
    mon = PoolMonitor()
    fleet = [FakePool(load=float(i % 7)) for i in range(12)]
    for p in fleet:
        mon.register_pool(p)
    meshed = port_sampler(mon, mesh, axes)
    plain = port_sampler(mon)
    jmeshed = jsampler.FleetSampler({'monitor': mon, 'mesh': jmesh,
                                     'meshAxes': axes})
    for k in range(6):
        for i, p in enumerate(fleet[::3]):
            p._load = float((i + k) % 9)
        rec_m = meshed.sample_once()
        assert_like_jax(rec_m, jmeshed.sample_once(), k)
        assert_same_as_plain(rec_m, plain.sample_once(), k)
    assert meshed.fs_capacity == 16
    assert len(meshed.fs_state) == 8
    assert meshed.snapshot()['mesh'] == jmeshed.snapshot()['mesh'] == {
        'axes': ['host', 'chip'], 'shape': {'host': 2, 'chip': 4},
        'n_devices': 8}


def test_mesh_capacity_rounds_up_and_grows(meshes):
    _, mesh, _ = meshes['1d']
    mon = PoolMonitor()
    for _ in range(3):
        mon.register_pool(FakePool())
    s = port_sampler(mon, mesh, capacity=3)
    # 3 rounds up to the mesh size...
    assert s.fs_capacity == 8
    assert s.sample_once()['fleet']['n_pools'] == 3
    # ...and growth doubles from there, the padded state placed on the
    # mesh again.
    for _ in range(9):
        mon.register_pool(FakePool())
    rec = s.sample_once()
    assert s.fs_capacity == 16
    assert rec['fleet']['n_pools'] == 12
    assert [st.windows.shape[0] for st in s.fs_state] == [2] * 8
    assert rec['fleet']['mean_load'] == pytest.approx(3.0, rel=1e-6)


def test_mesh_row_recycle_resets_sharded_state(meshes):
    _, mesh, _ = meshes['1d']
    mon = PoolMonitor()
    a, b = FakePool(load=6.0), FakePool(load=1.0)
    mon.register_pool(a)
    mon.register_pool(b)
    # Fill every row, so a retired row is really handed to a newcomer.
    for _ in range(6):
        mon.register_pool(FakePool(load=1.0))
    s = port_sampler(mon, mesh)
    for _ in range(6):
        rec = s.sample_once()
    row_a = s.fs_rows[a.p_uuid]
    filt_a = rec['pools'][a.p_uuid]['filtered']
    assert filt_a > 0.2

    mon.unregister_pool(a)
    c = FakePool(load=1.0)
    mon.register_pool(c)
    rec = s.sample_once()
    assert s.fs_rows[c.p_uuid] == row_a
    # One tick of load 1 through a cleared window, on row_a's shard.
    assert rec['pools'][c.p_uuid]['filtered'] < filt_a / 2
    assert rec['pools'][b.p_uuid]['filtered'] > 0.2
    assert float(s.fs_state[row_a].windows[0, :-1].abs().sum()) == 0.0


def test_snapshot_reports_mesh_like_jax(meshes):
    jmesh, mesh, _ = meshes['1d']
    got = port_sampler(PoolMonitor(), mesh).snapshot()['mesh']
    want = jsampler.FleetSampler({'monitor': PoolMonitor(),
                                  'mesh': jmesh}).snapshot()['mesh']
    assert got == want == {'axes': ['pools'], 'shape': {'pools': 8},
                           'n_devices': 8}
    assert port_sampler(PoolMonitor()).snapshot()['mesh'] is None


def test_each_shard_ping_pongs_its_ring(meshes):
    """In place of donation: after the second tick no tick allocates a
    window ring, and no two shards share one."""
    _, mesh, _ = meshes['1d']
    mon = PoolMonitor()
    mon.register_pool(FakePool())
    s = port_sampler(mon, mesh)
    ptrs = []
    for _ in range(5):
        s.sample_once()
        ptrs.append([st.windows.data_ptr() for st in s.fs_state])
    assert ptrs[1] == ptrs[3] and ptrs[2] == ptrs[4]
    assert len(set(ptrs[1] + ptrs[2])) == 16
    spares = [ls._spare.data_ptr() for ls in s.fs_step.lives]
    assert spares == ptrs[3]


def test_actuation_through_mesh_sampler(meshes):
    _, mesh, _ = meshes['1d']

    async def t():
        ctx = Ctx()
        pool, inner = make_pool(ctx, spares=1, maximum=4,
                                fleetActuation=True)
        inner.emit('added', 'a1', {})
        await settle()
        for c in list(ctx.connections):
            c.connect()
        await settle()
        mon = PoolMonitor()
        mon.register_pool(pool)
        s = port_sampler(mon, mesh, actuate=True, taps=4)
        for _ in range(6):       # warm-up gate: taps (4) ticks
            await asyncio.sleep(0)
            rec = s.sample_once()
        adv = pool.p_fleet_advisory
        assert adv is not None
        assert adv[0] == pytest.approx(
            rec['pools'][pool.p_uuid]['filtered'], rel=1e-6)
        pool.stop()
        await settle(30)
    run_async(t())


def test_step_failure_recovers_next_tick(meshes):
    _, mesh, _ = meshes['1d']
    mon = PoolMonitor()
    fake = FakePool()
    mon.register_pool(fake)
    s = port_sampler(mon, mesh, actuate=True)
    s.sample_once()
    s.sample_once()
    row = s.fs_rows[fake.p_uuid]
    assert s.fs_row_ticks[row] == 2
    real = s.fs_step

    def exploding(state, inp):
        real(state, inp)
        raise RuntimeError('transient device failure')

    s.fs_step = exploding
    with pytest.raises(RuntimeError, match='transient'):
        s.sample_once()
    assert s.fs_state is None and s.fs_input_cache == {}
    assert s.fs_row_ticks[row] == 0
    rec = s.sample_once()   # fresh sharded state, same row, reset applied
    assert rec['fleet']['n_pools'] == 1
    assert s.fs_rows[fake.p_uuid] == row
    assert len(s.fs_state) == 8


def test_input_cache_reships_only_changed_columns(meshes):
    _, mesh, _ = meshes['1d']
    mon = PoolMonitor()
    fake = FakePool()
    mon.register_pool(fake)
    s = port_sampler(mon, mesh)
    s.sample_once()
    kept = s.fs_input_cache['maximum'][1]
    samples0 = s.fs_input_cache['samples'][1]
    assert isinstance(kept, tuple) and len(kept) == 8   # one per shard
    s.sample_once()
    assert s.fs_input_cache['maximum'][1] is kept
    assert s.fs_input_cache['samples'][1] is samples0
    fake._load = 5.0
    s.sample_once()
    assert s.fs_input_cache['samples'][1] is not samples0
    assert s.fs_input_cache['maximum'][1] is kept
    row = s.fs_rows[fake.p_uuid]
    assert float(s.fs_input_cache['samples'][1][row][0]) == 5.0


def test_mesh_churn_soak_matches_jax_and_plain(frozen_clock, meshes):
    """Seeded churn with control and health on: pools arrive and leave
    (rows grow, recycle, reset), loads move, CoDel targets and queue
    sojourns on some pools, attributed claims for the health planes,
    and a clock rebase of the sharded state mid-run. The port mesh
    sampler agrees with the JAX mesh sampler and with the port's plain
    sampler on every tick."""

    class Codel:
        def __init__(self, target):
            self.cd_targdelay = target

    class Waiter:
        def __init__(self, started):
            self.ch_started = started

        def is_in_state(self, st):
            return st == 'waiting'

    jmesh, mesh, _ = meshes['1d']
    rng = np.random.default_rng(42)
    mon = PoolMonitor()
    opts = dict(control=True, health=True, taps=8)
    meshed = port_sampler(mon, mesh, **opts)
    plain = port_sampler(mon, **opts)
    jmeshed = jsampler.FleetSampler(dict(opts, monitor=mon, record=True,
                                         mesh=jmesh))
    fleet = []

    def spawn():
        p = FakePool(load=float(rng.uniform(0, 8)))
        if rng.uniform() < 0.4:
            p.p_codel = Codel(float(rng.choice([300.0, 1000.0])))
        fleet.append(p)
        mon.register_pool(p)

    for _ in range(4):
        spawn()
    drops = 0
    epoch0 = meshed.fs_epoch
    try:
        for tick in range(24):
            frozen_clock.advance(100 if tick != 12
                                 else jsampler.EPOCH_LIMIT)
            if rng.uniform() < 0.4 and len(fleet) < 14:
                spawn()
            if rng.uniform() < 0.15 and len(fleet) > 2:
                mon.unregister_pool(fleet.pop(int(rng.integers(len(fleet)))))
            for p in fleet:
                if rng.uniform() < 0.3:
                    p._load = float(rng.uniform(0, 8))
                if p.p_codel is not None:
                    p.p_waiters = [Waiter(
                        frozen_clock() - float(rng.uniform(0, 1500)))] \
                        if rng.uniform() < 0.5 else []
            for _ in range(16):
                key = 'soak-%d' % int(rng.integers(6))
                ms = float(rng.uniform(1, 6)) * (
                    40.0 if key == 'soak-5' else 1.0)
                for sink in mod_trace._BACKEND_SINKS:
                    sink.observe(key, ms, ms + 1.0, True)
            want = jmeshed.sample_once()
            got = meshed.sample_once()
            assert_records_agree(got, want, tick)
            assert_same_as_plain(got, plain.sample_once(), tick)
            drops += sum(r['drop'] for r in got['pools'].values())
        # All three rebased their clock, by the same shift.
        assert meshed.fs_epoch > epoch0
        assert meshed.fs_epoch == jmeshed.fs_epoch == plain.fs_epoch
        assert meshed.fs_capacity == 16          # growth happened
        assert drops > 0
        assert 'soak-5' in got['health']['gray']
        assert len(meshed.fs_ctrl_state) == 8
    finally:
        for s in (meshed, plain, jmeshed):
            s.stop()


def test_reduce_fleet_over_a_mesh_matches_jax(meshes):
    rng = np.random.default_rng(5)
    records = [{'n_pools': float(rng.integers(0, 50)),
                'mean_load': float(rng.uniform(0, 8)),
                'mean_filtered': float(rng.uniform(0, 8)),
                'overload_frac': float(rng.uniform()),
                'max_sojourn': float(rng.uniform(0, 900)),
                'retry_frac': float(rng.uniform()),
                'mean_retry_backoff': float(rng.uniform(0, 5000)),
                'loop_lag_p99_us': float(rng.uniform(0, 100))}
               for _ in range(11)]
    plain = tsampler.reduce_fleet(records)
    for name in ('1d', '2d'):
        jmesh, mesh, axes = meshes[name]
        got = tsampler.reduce_fleet(records + [None], mesh=mesh,
                                    mesh_axes=axes)
        want = jsampler.reduce_fleet(records, mesh=jmesh, mesh_axes=axes)
        assert got.keys() == want.keys() == plain.keys()
        for key, v in want.items():
            assert got[key] == pytest.approx(v, rel=1e-6), (name, key)
            assert got[key] == pytest.approx(plain[key], rel=1e-6), (
                name, key)
        assert got['n_pools'] == plain['n_pools']
        assert got['max_sojourn'] == plain['max_sojourn']
