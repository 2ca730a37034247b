"""The PyTorch port's FleetSampler on live pools, on the CPU.

The port's sampler drives the JAX package's real ConnectionPools (it
reaches them only through the pool surface and the push protocol) and
reads the JAX package's process state through the ``host`` seam. The
clock is frozen and advanced by hand, so no test waits on it.

- the tests of tests/test_sampler.py: parity with the pools' own Python
  laws, the retry-backoff ladder, row recycling and masked aggregates,
  O(dirty) gathering, columns against the oracle under churn, and real
  pool hooks;
- lockstep: a JAX sampler and a port sampler over one PoolMonitor, with
  the control and health planes on, publish the same records tick for
  tick (`target` and the plans exactly off
  ``convert.target_near_boundary``);
- the transfer cache, failure recovery, and the defaults.
"""

import asyncio
import math

import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')

from cueball_tpu import metrics as mod_metrics  # noqa: E402
from cueball_tpu import netsim as j_netsim  # noqa: E402
from cueball_tpu import trace as mod_trace  # noqa: E402
from cueball_tpu import utils as mod_utils  # noqa: E402
from cueball_tpu.monitor import PoolMonitor  # noqa: E402
from cueball_tpu.parallel import sampler as jsampler  # noqa: E402
from cueball_tpu_torch import convert  # noqa: E402
from cueball_tpu_torch import monitor as tmonitor  # noqa: E402
from cueball_tpu_torch.parallel import sampler as tsampler  # noqa: E402
from cueball_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from cueball_tpu_torch.parallel.sampler import FleetSampler  # noqa: E402

from conftest import run_async, settle  # noqa: E402
from test_pool import Ctx, claim, make_pool  # noqa: E402
from test_sampler import (PushCodel, PushPool, PushSmgr,  # noqa: E402
                          PushWaiter, assert_columns_match_oracle,
                          replay_python_laws)
from test_torch_health import jax_host  # noqa: E402

CPU = 'cpu'


class FrozenClock:
    """Manually advanced stand-in for utils.current_millis."""

    def __init__(self):
        self.t = mod_utils.current_millis()

    def advance(self, ms):
        self.t += ms

    def __call__(self):
        return self.t


@pytest.fixture
def frozen_clock():
    saved = mod_utils.current_millis
    clk = FrozenClock()
    mod_utils.current_millis = clk
    try:
        yield clk
    finally:
        mod_utils.current_millis = saved


def make_sampler(pools, **opts):
    """A port FleetSampler on the CPU over a private monitor holding
    exactly `pools`."""
    mon = PoolMonitor()
    for p in pools:
        mon.register_pool(p)
    return FleetSampler({'monitor': mon, 'record': True, 'device': CPU,
                         'host': jax_host(), **opts})


async def connected_pools(ctx, specs):
    """Pools built by make_pool(ctx, **spec), each with its backends
    added and every connection connected."""
    pools = []
    for spec in specs:
        spec = dict(spec)
        keys = spec.pop('keys')
        pool, inner = make_pool(ctx, **spec)
        for k in keys:
            inner.emit('added', k, {})
        pools.append(pool)
    await settle()
    for c in list(ctx.connections):
        if not c.connected and not c.dead:
            c.connect()
    await settle()
    return pools


def test_sampler_parity_with_python_laws(frozen_clock):
    async def t():
        ctx = Ctx()
        pool_a, pool_b = await connected_pools(ctx, [
            dict(spares=2, maximum=2, targetClaimDelay=300, keys=['a1']),
            dict(spares=3, maximum=6, keys=['b1', 'b2'])])
        sampler = make_sampler([pool_a, pool_b])

        held = []
        for _ in range(2):
            fut, _ = claim(pool_a)
            held.append(await fut)
        queued = [claim(pool_a) for _ in range(3)]

        for tick in range(30):
            await settle(2)
            frozen_clock.advance(20)
            rec = sampler.sample_once()
            assert set(rec['pools']) == {pool_a.p_uuid, pool_b.p_uuid}
            if tick % 7 == 3 and held:
                hdl, _ = held.pop()
                hdl.release()

        for fut, waiter in queued:
            if not fut.done():
                waiter.cancel()
        for hdl, _ in held:
            hdl.release()

        history = sampler.fs_history
        assert len(history) == 30
        for pool in (pool_a, pool_b):
            expect = replay_python_laws(history, pool.p_uuid)
            for k, (rec, exp) in enumerate(zip(history, expect)):
                got = rec['pools'][pool.p_uuid]
                assert got['filtered'] == pytest.approx(
                    exp['filtered'], rel=1e-4, abs=1e-4), (pool.p_uuid, k)
                assert got['target'] == pytest.approx(
                    exp['target'], rel=1e-5), (pool.p_uuid, k)
                assert got['drop'] == exp['drop'], (pool.p_uuid, k)
            if pool.p_codel is None:
                assert not any(r['pools'][pool.p_uuid]['drop']
                               for r in history)
        # The load exercised the laws: queued waiters had sojourns, and
        # CoDel dropped at least once.
        assert any(r['pools'][pool_a.p_uuid]['inputs']['sojourn'] > 0
                   for r in history)
        assert any(r['pools'][pool_a.p_uuid]['drop'] for r in history)
        pool_a.stop()
        pool_b.stop()
        await settle(30)
    run_async(t())


def test_sampler_retry_backoff_matches_smgr():
    """The batched ladder reproduces the deepest slot's sm_delay. The
    slots' backoff runs on the loop's own timers, so this test yields
    to the loop for a few milliseconds per step (short delays keep the
    whole climb under ~0.1 s)."""
    async def t():
        ctx = Ctx()
        pool, inner = make_pool(ctx, spares=1, maximum=2, recovery={
            'default': {'timeout': 4, 'retries': 8, 'delay': 2,
                        'maxDelay': 16}})
        inner.emit('added', 'b1', {})
        sampler = make_sampler([pool])

        deadline = asyncio.get_running_loop().time() + 5.0
        saw_ladder = []
        while asyncio.get_running_loop().time() < deadline:
            await asyncio.sleep(0.002)
            rec = sampler.sample_once()
            got = rec['pools'][pool.p_uuid]
            deepest = None
            n_backoff = 0
            for slots in pool.p_connections.values():
                for slot in slots:
                    smgr = slot.get_socket_mgr()
                    if smgr.is_in_state('backoff') and \
                            math.isfinite(smgr.sm_retries):
                        n_backoff += 1
                        a = smgr.sm_retries - smgr.sm_retries_left
                        if deepest is None or a >= deepest[0]:
                            deepest = (a, smgr.sm_delay)
            if n_backoff == 0:
                continue
            assert got['inputs']['n_retrying'] == n_backoff
            assert got['retry_backoff'] == pytest.approx(deepest[1],
                                                         rel=1e-6)
            saw_ladder.append(deepest[0])
            if len(saw_ladder) > 4 and max(saw_ladder) >= 3:
                break
        assert saw_ladder, 'no backoff ever observed'
        assert max(saw_ladder) >= 3, 'ladder never climbed'
        assert sampler.fs_latest['fleet']['retry_frac'] in (0.0, 1.0)
        pool.stop()
        await settle(30)
    run_async(t())


def test_sampler_row_recycle_and_masked_aggregates(frozen_clock):
    async def t():
        ctx = Ctx()
        pool_a, pool_b = await connected_pools(ctx, [
            dict(spares=1, maximum=2, keys=['a1']),
            dict(spares=1, maximum=2, keys=['b1'])])
        sampler = make_sampler([pool_a, pool_b], capacity=2)
        mon = sampler.fs_monitor
        for _ in range(10):
            frozen_clock.advance(5)
            rec = sampler.sample_once()
        assert rec['fleet']['n_pools'] == 2
        vals = [rec['pools'][u]['inputs']['sample']
                for u in (pool_a.p_uuid, pool_b.p_uuid)]
        assert rec['fleet']['mean_load'] == pytest.approx(sum(vals) / 2,
                                                          rel=1e-5)
        row_a = sampler.fs_rows[pool_a.p_uuid]
        filt_a = rec['pools'][pool_a.p_uuid]['filtered']
        assert filt_a > 0.2

        # Pool A leaves; a new pool C inherits its row with a clean
        # window (reset), while pool B's state carries over.
        mon.unregister_pool(pool_a)
        (pool_c,) = await connected_pools(ctx, [
            dict(spares=1, maximum=2, keys=['c1'])])
        mon.register_pool(pool_c)
        rec = sampler.sample_once()
        assert sampler.fs_rows[pool_c.p_uuid] == row_a
        assert rec['pools'][pool_c.p_uuid]['filtered'] < filt_a
        assert rec['fleet']['n_pools'] == 2

        # Growth: a fourth pool forces capacity doubling; pool B's
        # state carries across the pad.
        filt_b_before = rec['pools'][pool_b.p_uuid]['filtered']
        (pool_d,) = await connected_pools(ctx, [
            dict(spares=1, maximum=2, keys=['d1'])])
        mon.register_pool(pool_d)
        rec = sampler.sample_once()
        assert sampler.fs_capacity == 4
        assert sampler.fs_state.windows.shape == (4, 128)
        assert rec['fleet']['n_pools'] == 3
        assert rec['pools'][pool_b.p_uuid]['filtered'] == pytest.approx(
            filt_b_before, rel=0.2)
        for p in (pool_a, pool_b, pool_c, pool_d):
            p.stop()
        await settle(30)
    run_async(t())


def test_idle_fleet_tick_visits_o_dirty_not_o_fleet():
    mon = PoolMonitor()
    fleet = [PushPool(load=float(i % 5)) for i in range(1000)]
    for p in fleet:
        mon.register_pool(p)
    s = FleetSampler({'monitor': mon, 'device': CPU})

    s.sample_once()
    assert s.fs_tick_visits == 1000   # first tick gathers everything
    assert not s.fs_polled            # push pools are never polled

    base = s.fs_gather_visits
    for _ in range(5):
        s.sample_once()
        assert s.fs_tick_visits == 0  # idle fleet: no rows re-read
    assert s.fs_gather_visits == base

    for p in fleet[::100]:            # 10 pools move...
        p.set_load(p._load + 1.0)
        p.set_load(p._load + 1.0)     # ...twice each: events dedupe
    s.sample_once()
    assert s.fs_tick_visits == 10
    assert s.fs_gather_visits == base + 10
    for p in fleet[::100]:
        assert_columns_match_oracle(s, p)


def test_gather_once_patches_dirty_rows_between_ticks():
    fleet = [PushPool(load=float(i % 5)) for i in range(100)]
    s = make_sampler(fleet)
    s.sample_once()
    ticks = s.fs_ticks
    for p in fleet[::10]:
        p.set_load(p._load + 2.0)
    assert s.gather_once() == 10      # the dirty rows, outside a tick
    assert s.fs_ticks == ticks
    for p in fleet[::10]:
        assert_columns_match_oracle(s, p)
    assert s.gather_once() == 0       # nothing moved since
    s.sample_once()
    assert s.fs_tick_visits == 0      # the tick finds them gathered


def test_timer_emitter_delivers_in_order_until_removed():
    s = make_sampler([PushPool(load=1.0)])
    assert s.fs_emitter.emit('timeout')   # what the interval timer emits
    assert s.fs_ticks == 1
    seen = []
    listener = s.fs_emitter.on('timeout', lambda: seen.append(s.fs_ticks))
    s.fs_emitter.emit('timeout')
    assert s.fs_ticks == 2 and seen == [2]   # after the sampler's tick
    s.fs_emitter.remove_listener('timeout', listener)
    s.fs_emitter.emit('timeout')
    assert s.fs_ticks == 3 and seen == [2]


def test_push_churn_columns_agree_with_oracle(frozen_clock):
    rng = np.random.default_rng(7)
    mon = PoolMonitor()
    s = FleetSampler({'monitor': mon, 'device': CPU, 'host': jax_host()})
    fleet = []

    def spawn():
        p = PushPool(load=float(rng.uniform(0, 8)))
        if rng.uniform() < 0.5:
            p.p_codel = PushCodel(float(rng.choice([300.0, 1000.0])))
        fleet.append(p)
        mon.register_pool(p)

    for _ in range(6):
        spawn()
    freed_rows = []
    for tick in range(60):
        frozen_clock.advance(100)
        if rng.uniform() < 0.25 and len(fleet) < 24:
            spawn()
        if rng.uniform() < 0.15 and len(fleet) > 2:
            gone = fleet.pop(int(rng.integers(len(fleet))))
            freed_rows.append(s.fs_rows[gone.p_uuid])
            mon.unregister_pool(gone)
        for p in fleet:
            if rng.uniform() < 0.4:
                p.set_load(float(rng.uniform(0, 8)))
            if rng.uniform() < 0.15:
                p.set_spares(float(rng.integers(0, 5)))
            if p.p_codel is not None and rng.uniform() < 0.5:
                p.set_waiters(
                    [PushWaiter(frozen_clock() - float(rng.uniform(0, 1500)))]
                    if rng.uniform() < 0.6 else [])
            if rng.uniform() < 0.2:
                p.set_backoff([PushSmgr(5, int(rng.integers(1, 5)),
                                        100.0, 10000.0)]
                              if rng.uniform() < 0.7 else [])
        s.sample_once()
        for p in fleet:
            assert_columns_match_oracle(s, p)
        occupied = set(s.fs_rows.values())
        for row in freed_rows:
            if row in occupied:
                continue
            assert not s.fs_active[row], tick
            assert s.fs_head_ts[row] == 0.0, tick
            for name, default in tsampler._COL_DEFAULTS.items():
                assert float(s.fs_cols[name][row]) == np.float32(default), (
                    tick, name)
    assert freed_rows
    assert not s.fs_polled


def test_real_pool_event_hooks_keep_columns_fresh(frozen_clock):
    async def t():
        ctx = Ctx()
        (pool,) = await connected_pools(ctx, [
            dict(spares=2, maximum=2, targetClaimDelay=300, keys=['a1'])])
        sampler = make_sampler([pool])
        held, queued = [], []
        try:
            for _ in range(2):
                fut, _ = claim(pool)
                held.append(await fut)
            queued.extend(claim(pool) for _ in range(3))
            for tick in range(25):
                await settle(2)
                frozen_clock.advance(10)
                sampler.sample_once()
                assert not sampler.fs_polled   # real pools push
                assert_columns_match_oracle(sampler, pool)
                if tick % 6 == 2 and held:
                    hdl, _ = held.pop()
                    hdl.release()
                if tick % 6 == 5:
                    queued.append(claim(pool))
                for item in list(queued):
                    if item[0].done():
                        held.append(await item[0])
                        queued.remove(item)
        finally:
            for fut, waiter in queued:
                if fut.done():
                    (await fut)[0].release()
                else:
                    waiter.cancel()
            for hdl, _ in held:
                hdl.release()
            pool.stop()
        await settle(30)
    run_async(t())


# -- lockstep against the JAX sampler ---------------------------------------

def assert_records_agree(got, want, tag):
    """A port tick record against the JAX sampler's for the same tick."""
    assert got['tick'] == want['tick'] and got['now_ms'] == want['now_ms']
    assert set(got['pools']) == set(want['pools']), tag
    edge_rows = set()
    for uuid, w in want['pools'].items():
        g = got['pools'][uuid]
        assert g['inputs'] == w['inputs'], (tag, uuid)
        assert g['row'] == w['row'], (tag, uuid)
        for key in ('filtered', 'retry_backoff'):
            assert g[key] == pytest.approx(w[key], rel=1e-5, abs=1e-5), (
                tag, uuid, key)
        assert g['drop'] == w['drop'], (tag, uuid)
        inp = w['inputs']
        if convert.target_near_boundary(
                np.float32(w['filtered']), np.float32(inp['sample']),
                np.float32(inp['spares'])):
            # A ceil flip moves the target by at most one connection.
            assert abs(g['target'] - w['target']) <= 1.0, (tag, uuid)
            edge_rows.add(w['row'])
            continue
        assert (g['target'], g['clamped']) == (w['target'], w['clamped']), (
            tag, uuid)
    for key, v in want['fleet'].items():
        assert got['fleet'][key] == pytest.approx(v, rel=1e-5, abs=1e-5), (
            tag, key)

    gc, wc = got['control'], want['control']
    for key in ('applied', 'rejected', 'skipped', 'epoch', 'step_ms'):
        assert gc[key] == wc[key], (tag, key)
    for key, v in wc['fleet'].items():
        assert gc['fleet'][key] == pytest.approx(v, rel=1e-5), (tag, key)
    rows = [w['row'] for w in want['pools'].values()
            if w['row'] not in edge_rows]
    for key, v in wc['decisions'].items():
        v = np.asarray(v)
        assert gc['decisions'][key].dtype == v.dtype, (tag, key)
        if v.ndim:
            np.testing.assert_array_equal(gc['decisions'][key][rows],
                                          v[rows], err_msg='%s %s'
                                          % (tag, key))
        else:
            assert gc['decisions'][key] == v, (tag, key)

    gh, wh = got['health'], want['health']
    assert (gh['epoch'], gh['at_ms'], gh['gray']) == (
        wh['epoch'], wh['at_ms'], wh['gray']), tag
    assert sorted(gh['backends']) == sorted(wh['backends']), tag
    for key, wb in wh['backends'].items():
        gb = gh['backends'][key]
        assert (gb['gray'], gb['score']) == (wb['gray'], wb['score']), (
            tag, key)
        assert gb['ewma_ms'] == pytest.approx(wb['ewma_ms'], rel=1e-5)
    for key, v in wh['fleet'].items():
        assert type(gh['fleet'][key]) is type(v), (tag, key)
        assert gh['fleet'][key] == pytest.approx(v, rel=1e-5), (tag, key)
    return len(edge_rows)


def test_lockstep_with_jax_sampler_control_and_health():
    """A JAX FleetSampler and a port one over the same live pools, with
    control and health on, under load and with a clock rebase mid-run:
    every tick's records agree. The pools' timers and both samplers run
    on netsim's virtual loop and clock, advanced by hand, so the real
    seconds that JAX spends compiling expire no queued claim. The jump
    at tick 12 expires the first queue, and a second one is queued
    after it."""
    clock = j_netsim.VirtualClock(start=1000.0)

    async def t():
        ctx = Ctx()
        pool_a, pool_b, pool_c = await connected_pools(ctx, [
            dict(spares=2, maximum=2, targetClaimDelay=300, keys=['ls-a1']),
            dict(spares=3, maximum=6, keys=['ls-b1', 'ls-b2']),
            dict(spares=1, maximum=4, targetClaimDelay=100,
                 keys=['ls-c1'])])
        mon = PoolMonitor()
        for p in (pool_a, pool_b, pool_c):
            mon.register_pool(p)
        opts = {'monitor': mon, 'record': True, 'control': True,
                'health': True, 'taps': 8}
        want_s = jsampler.FleetSampler(dict(opts))
        got_s = FleetSampler(dict(opts, device=CPU, host=jax_host()))
        rng = np.random.default_rng(31)
        edge_rows = assert_records_agree(got_s.sample_once(),
                                         want_s.sample_once(), 'warm')
        held = []
        for _ in range(2):
            fut, _ = claim(pool_a)
            held.append(await fut)
        queued = [claim(pool_a) for _ in range(3)]
        try:
            for tick in range(24):
                await settle(2)
                # 50 ms ticks take pool_a's queued claims past its
                # 300 ms CoDel target, and the laws to a drop, before
                # the jump at tick 12 expires their 3 s claim timeout.
                step_ms = 50 if tick != 12 else jsampler.EPOCH_LIMIT
                clock.advance(step_ms / 1000.0)
                # Attributed claims for the health planes, offered to
                # every registered sink as a tracer would.
                for _ in range(30):
                    key = str(rng.choice(['ls-a1', 'ls-b1', 'ls-b2', 'ls-c1',
                                          'ls-x', 'ls-y']))
                    ms = float(rng.uniform(1, 6)) * (
                        50.0 if key == 'ls-c1' else 1.0)
                    ok = bool(rng.random() < 0.95)
                    for sink in mod_trace._BACKEND_SINKS:
                        sink.observe(key, ms if ok else None, ms + 1.0, ok)
                want = want_s.sample_once()
                got = got_s.sample_once()
                edge_rows += assert_records_agree(got, want, tick)
                if tick == 12:
                    # The jump expired the queue: load it again, so
                    # the laws run over a loaded queue after the rebase.
                    queued += [claim(pool_a) for _ in range(3)]
                if tick % 7 == 3 and held:
                    hdl, _ = held.pop()
                    hdl.release()
            assert got_s.fs_epoch == want_s.fs_epoch   # both rebased
            assert got_s.fs_ticks == 25
            # The run exercised the laws and both planes.
            hist = got_s.fs_history
            assert any(r['pools'][pool_a.p_uuid]['drop'] for r in hist)
            # ... and over the queue loaded after the rebase (a record's
            # 'tick' counts the warm tick, so loop tick 12 is record 14).
            assert any(r['pools'][pool_a.p_uuid]['drop']
                       for r in hist if r['tick'] > 12 + 2)
            assert hist[-1]['control']['rejected'] == 3   # past warm-up
            assert 'ls-c1' in hist[-1]['health']['gray']
            # Steady integer loads put many rows' filtered load within
            # 1e-4 of an integer; the rest are held exactly.
            assert edge_rows < 25 * 3
            snap = got_s.snapshot()
            assert snap['control']['last']['epoch'] == 25
            assert snap['health']['monitor']['last']['epoch'] == 25
        finally:
            want_s.stop()
            got_s.stop()
            for fut, waiter in queued:
                if not fut.done():
                    waiter.cancel()
                elif not fut.cancelled():
                    fut.exception()   # a claim timed out on the clock
            for hdl, _ in held:
                hdl.release()
            for p in (pool_a, pool_b, pool_c):
                p.stop()
        await settle(30)
    j_netsim.run(t(), clock=clock)


# -- transfer cache, failure recovery, defaults ------------------------------

class FakePool:
    """The minimal gather_pool surface, for row mechanics."""

    _seq = 0

    def __init__(self, load=3.0):
        FakePool._seq += 1
        self.p_uuid = 'torch-fake-%d' % FakePool._seq
        self.p_spares = 2.0
        self.p_max = 8.0
        self.p_codel = None
        self.p_waiters = []
        self.p_connections = {}
        self._load = load

    def lp_load_sample(self):
        return self._load


def test_input_cache_reships_only_changed_columns():
    mon = PoolMonitor()
    fake = FakePool()
    mon.register_pool(fake)
    s = FleetSampler({'monitor': mon, 'device': CPU})
    s.sample_once()
    kept = s.fs_input_cache['maximum'][1]
    samples0 = s.fs_input_cache['samples'][1]
    s.sample_once()
    # Static column: the cached device tensor is reused as it is.
    assert s.fs_input_cache['maximum'][1] is kept
    assert s.fs_input_cache['samples'][1] is samples0  # load unchanged
    fake._load = 5.0
    s.sample_once()
    assert s.fs_input_cache['samples'][1] is not samples0
    assert s.fs_input_cache['maximum'][1] is kept
    # The device tensor is a copy: it does not alias the host column.
    host, dev = s.fs_input_cache['samples']
    assert dev.data_ptr() != host.ctypes.data
    assert float(dev[s.fs_rows[fake.p_uuid]]) == 5.0


def test_step_failure_resets_every_row():
    """A failed step drops the state and flags every occupied row for
    reset, as the JAX sampler does after its donated step fails; the
    next tick restarts from a clean state on the same rows."""
    mon = PoolMonitor()
    fakes = [FakePool(load=4.0), FakePool(load=6.0)]
    for f in fakes:
        mon.register_pool(f)
    s = FleetSampler({'monitor': mon, 'actuate': True, 'device': CPU})
    for _ in range(3):
        rec = s.sample_once()
    rows = {f.p_uuid: s.fs_rows[f.p_uuid] for f in fakes}
    warm = {u: rec['pools'][u]['filtered'] for u in rows}
    assert all(s.fs_row_ticks[r] == 3 for r in rows.values())

    real = s.fs_step

    def exploding(state, inp):
        real(state, inp)
        raise RuntimeError('transient device failure')

    s.fs_step = exploding
    with pytest.raises(RuntimeError, match='transient'):
        s.sample_once()
    assert s.fs_state is None
    assert s.fs_input_cache == {}
    assert s.fs_pending_reset == set(rows.values())
    assert all(s.fs_row_ticks[r] == 0 for r in rows.values())

    rec = s.sample_once()   # fresh state, same rows, reset applied
    assert rec['fleet']['n_pools'] == 2
    for uuid, row in rows.items():
        assert s.fs_rows[uuid] == row
        # One sample into a zeroed window reads far below the warm one.
        assert rec['pools'][uuid]['filtered'] < warm[uuid] / 2
    assert not s.fs_pending_reset


def test_defaults_start_stop_and_snapshot():
    if torch.cuda.is_available():
        assert FleetSampler().fs_device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='CUDA'):
            FleetSampler()
    # The mesh option exists: the snapshot names the mesh, and
    # reduce_fleet takes one.
    mesh = Mesh([CPU] * 2, ('pools',))
    meshed = FleetSampler({'mesh': mesh, 'monitor': tmonitor.PoolMonitor()})
    assert meshed.snapshot()['mesh'] == {
        'axes': ['pools'], 'shape': {'pools': 2}, 'n_devices': 2}
    assert meshed.fs_device.type == 'cpu' and meshed.fs_capacity == 8
    assert tsampler.reduce_fleet([], mesh=mesh, mesh_axes=('pools',)) == \
        tsampler.reduce_fleet([])

    async def t():
        mon = tmonitor.PoolMonitor()
        fake = FakePool()
        mon.register_pool(fake)
        collector = mod_metrics.create_collector()
        s = FleetSampler({'monitor': mon, 'device': CPU, 'interval': 50,
                          'collector': collector})
        mon.attach_fleet_sampler(s)
        s.start()                      # one synchronous tick, then timer
        assert s.fs_ticks == 1 and s.fs_timer is not None
        s.stop()
        assert s.fs_timer is None
        snap = mon.fleet_snapshot()
        assert snap['attached'] is True and snap['mesh'] is None
        assert snap['latest']['fleet']['n_pools'] == 1.0
        assert snap['rows'] == {fake.p_uuid: 0}
        assert 'cueball_fleet_mean_load' in collector.collect()
        mon.unregister_pool(fake)
        assert mon.pm_generation == 2
        mon.detach_fleet_sampler()
        assert mon.fleet_snapshot() == {'attached': False}
    run_async(t())


def test_reduce_fleet_matches_jax():
    a = {'n_pools': 3.0, 'mean_load': 2.0, 'mean_filtered': 1.5,
         'overload_frac': 0.25, 'max_sojourn': 12.0, 'retry_frac': 0.0,
         'mean_retry_backoff': 0.0, 'loop_lag_p99_us': 40.0}
    b = dict(a, n_pools=1.0, mean_load=6.0, max_sojourn=80.0,
             loop_lag_p99_us=10.0)
    got = tsampler.reduce_fleet([a, None, b])
    assert got == jsampler.reduce_fleet([a, None, b])
    assert got['n_pools'] == 4.0 and got['max_sojourn'] == 80.0
    assert got['mean_load'] == pytest.approx(3.0)
    assert tsampler.reduce_fleet([]) == jsampler.reduce_fleet([])


# -- the roster: cached rows, warm gate, bound entry points -----------------

class AdvisedPool(FakePool):
    """A FakePool that takes advisories, and records them."""

    def __init__(self, load=3.0):
        super().__init__(load)
        self.advisories = []

    def receive_fleet_advisory(self, filtered, at_ms):
        self.advisories.append((filtered, at_ms))


class DecidedPool(FakePool):
    """A FakePool that takes control decisions, records each offer and
    answers ``accept``."""

    def __init__(self, load=3.0, accept=True):
        super().__init__(load)
        self.accept = accept
        self.offers = []

    def apply_control_decision(self, epoch, codel_target=None, spares=None,
                               at_ms=None, health=None):
        self.offers.append((epoch, codel_target, spares, at_ms, health))
        return self.accept


class ActuatedPool(DecidedPool, AdvisedPool):
    """Both entry points."""


def actuated_sampler(pools, taps=2, **opts):
    return make_sampler(pools, taps=taps, actuate=True, control=True,
                        **opts)


def test_roster_rebuilds_only_when_the_row_map_changes(frozen_clock):
    pools = [ActuatedPool(load=float(i % 5)) for i in range(300)]
    s = actuated_sampler(pools)
    mon = s.fs_monitor
    for _ in range(4):
        s.sample_once()
        frozen_clock.advance(200)
    assert s.snapshot()['roster_builds'] == 1
    extra = ActuatedPool()
    mon.register_pool(extra)
    for _ in range(3):
        s.sample_once()
        frozen_clock.advance(200)
    assert s.snapshot()['roster_builds'] == 2
    mon.unregister_pool(pools[7])
    s.sample_once()
    s.sample_once()
    snap = s.snapshot()
    assert snap['roster_builds'] == 3
    # The freed row keeps its count and its key; the new pool counts
    # from its own assignment.
    assert snap['row_ticks'][snap['rows'][pools[0].p_uuid]] == 9
    assert snap['row_ticks'][snap['rows'][extra.p_uuid]] == 5
    freed = [r for r in snap['row_ticks'] if r not in snap['rows'].values()]
    assert len(freed) == 1 and snap['row_ticks'][freed[0]] == 7
    assert all(type(k) is int and type(v) is int
               for k, v in snap['row_ticks'].items())
    # The records of older ticks keep the row map of their own tick.
    assert pools[7].p_uuid not in s.fs_history[-1]['pools']
    assert pools[7].p_uuid in s.fs_history[-3]['pools']
    assert extra.p_uuid not in s.fs_history[3]['pools']
    # The released pool was last offered on the tick before it left.
    assert len(pools[7].advisories) == 7 - 1


def test_step_failure_restarts_every_rows_warm_up_gate(frozen_clock):
    pools = [ActuatedPool(load=float(i % 3)) for i in range(200)]
    s = actuated_sampler(pools, taps=3)
    for _ in range(4):
        s.sample_once()
        frozen_clock.advance(200)
    assert all(len(p.advisories) == 2 and len(p.offers) == 2 for p in pools)
    real = s.fs_step

    def exploding(state, inp):
        real(state, inp)
        raise RuntimeError('transient device failure')

    s.fs_step = exploding
    with pytest.raises(RuntimeError, match='transient'):
        s.sample_once()
    s.fs_step = real
    rows = list(s.fs_rows.values())
    assert all(s.fs_row_ticks[r] == 0 for r in rows)
    assert set(s.snapshot()['row_ticks'].values()) == {0}
    for tick in range(4):
        frozen_clock.advance(200)
        rec = s.sample_once()
        # Offered again only once `taps` ticks have passed.
        want = 2 + max(0, tick - 1)
        assert all(len(p.advisories) == want and len(p.offers) == want
                   for p in pools), tick
        assert rec['control']['applied'] == (200 if tick >= 2 else 0)
    assert s.snapshot()['roster_builds'] == 1


def test_pools_without_entry_points_are_skipped_and_counted(frozen_clock):
    pools = ([ActuatedPool() for _ in range(40)]
             + [AdvisedPool() for _ in range(30)]
             + [DecidedPool(accept=False) for _ in range(20)]
             + [FakePool() for _ in range(10)])
    s = actuated_sampler(pools, taps=1)
    for _ in range(3):
        rec = s.sample_once()
        frozen_clock.advance(200)
    ctl = rec['control']
    assert (ctl['applied'], ctl['rejected'], ctl['skipped']) == (40, 20, 40)
    for p in pools:
        if isinstance(p, AdvisedPool):
            assert len(p.advisories) == 3
            value, at = p.advisories[-1]
            assert type(value) is float
            assert value == float(np.float32(
                rec['pools'][p.p_uuid]['filtered']))
            assert at == frozen_clock.t - 200
        if isinstance(p, DecidedPool):
            assert [o[0] for o in p.offers] == [1, 2, 3]


def _decision_columns():
    ct = np.array([0.0, 250.0, -3.0, np.nan, 7.5, 1e9, 0.0, 42.0, 1.0, 60.0],
                  np.float32)
    sp = np.array([0, 3, 4, 10, 1, 2, 11, 5, -1, 6], np.int32)
    return {'codel_target': ct, 'plan_spares': sp,
            'epoch': np.asarray(7, np.int32)}


def _mixed_pools():
    return [ActuatedPool(), DecidedPool(accept=False), AdvisedPool(),
            DecidedPool(), FakePool(), ActuatedPool(), DecidedPool()]


@pytest.mark.parametrize('health', [None, {'epoch': 4, 'gray': ['b1']}])
@pytest.mark.parametrize('as_tensor', [False, True])
@pytest.mark.parametrize('form', ['dict', 'roster'])
def test_apply_decisions_roster_view_matches_a_plain_dict(health, as_tensor,
                                                          form):
    """The port's apply_decisions, over a plain dict or over the
    sampler's RowPools view, makes the JAX apply_decisions' calls on a
    plain dict of the same rows and pools."""
    from cueball_tpu.parallel.control import apply_decisions as jax_apply
    from cueball_tpu_torch.parallel.control import RowPools, apply_decisions

    rows = [5, 0, 9, 3, 8, 1, 7]
    decisions = _decision_columns()
    port_decisions = decisions
    if as_tensor:
        port_decisions = {k: torch.as_tensor(v) for k, v in decisions.items()}
    want_pools, got_pools = _mixed_pools(), _mixed_pools()
    got_map = dict(zip(rows, got_pools))
    if form == 'roster':
        got_map = RowPools(got_map, [getattr(p, 'apply_control_decision',
                                             None) for p in got_pools])
        # The view reads as the dict of the same rows and pools.
        assert list(got_map) == rows and len(got_map) == len(rows)
        assert dict(got_map) == dict(zip(rows, got_pools))
        assert list(got_map.values()) == got_pools and 4 not in got_map
    got = apply_decisions(got_map, port_decisions, at_ms=1234.5,
                          health=health)
    want = jax_apply(dict(zip(rows, want_pools)), decisions, at_ms=1234.5,
                     health=health)
    assert got == want == {'applied': 4, 'rejected': 1, 'skipped': 2,
                           'epoch': 7}
    for p, q in zip(want_pools, got_pools):
        assert getattr(p, 'offers', None) == getattr(q, 'offers', None)
        for a, b in zip(getattr(p, 'offers', ()), getattr(q, 'offers', ())):
            assert [type(x) for x in a] == [type(x) for x in b]
    assert got_pools[0].offers == [(7, 1e9, 2, 1234.5, health)]
    assert got_pools[1].offers == [(7, None, 0, 1234.5, health)]
    assert got_pools[3].offers == [(7, None, 10, 1234.5, health)]
    assert got_pools[5].offers == [(7, 250.0, 3, 1234.5, health)]
    assert type(got_pools[5].offers[0][1]) is float


def test_snapshot_row_ticks_keep_the_jax_samplers_keys_and_order(
        frozen_clock):
    """Over rows freed, taken again and grown past the capacity, the
    port's ``row_ticks`` has the JAX sampler's keys, values and order."""
    pools = [FakePool(load=float(i % 4)) for i in range(10)]
    mon = PoolMonitor()
    for p in pools:
        mon.register_pool(p)
    want_s = jsampler.FleetSampler({'monitor': mon, 'capacity': 12})
    got_s = FleetSampler({'monitor': mon, 'capacity': 12, 'device': CPU,
                          'host': jax_host()})

    def tick():
        got_s.sample_once()
        want_s.sample_once()
        frozen_clock.advance(200)

    try:
        tick()
        tick()
        for p in (pools[6], pools[0], pools[3]):
            mon.unregister_pool(p)
        tick()
        for _ in range(6):
            mon.register_pool(FakePool())
        tick()
        got, want = got_s.snapshot(), want_s.snapshot()
        assert got_s.fs_capacity > 12
        assert list(got['row_ticks'].items()) == list(
            want['row_ticks'].items())
        assert len(got['row_ticks']) == 13
    finally:
        got_s.stop()
        want_s.stop()
