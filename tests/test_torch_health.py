"""Parity of the PyTorch port's health step and its host glue with the
JAX package's.

Both packages step on identical numpy inputs, on the CPU. Integer work
(histograms, counts, median, MAD, streaks, epoch) agrees exactly. The
EWMA, z-score and burn floats agree to rtol 1e-5: XLA fuses the EWMA
and sketch updates into multiply-adds and PyTorch eager does not, and
``log2``/``exp2`` differ in the last bit. So `score` and the verdicts
downstream of it are held exactly on every backend off the score's
rounding boundary (``convert.health_score_near_boundary``), and each
test asserts how many backends lie on it.

The law tests are those of tests/test_health.py, asserted on both
packages at once. The host glue (BackendTable, HealthMonitor,
reduce_health) runs the port over the JAX package's own host state
through the ``host`` seam.

A NaN or out-of-range score float casts by XLA's saturating rule in
both packages (NaN to 0): the non-finite ``lat_sum`` rows and their
frozen JAX numbers are ``chip_smoke.py``'s, held here against the JAX
package itself.
"""


import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')

from cueball_tpu import metrics as mod_metrics  # noqa: E402
from cueball_tpu import pool as mod_pool  # noqa: E402
from cueball_tpu import trace as mod_trace  # noqa: E402
from cueball_tpu import utils as mod_utils  # noqa: E402
from cueball_tpu import wiretap as mod_wiretap  # noqa: E402
from cueball_tpu.parallel import health as JH  # noqa: E402
from cueball_tpu_torch import convert, host  # noqa: E402
from cueball_tpu_torch._device import to_host_values  # noqa: E402
from cueball_tpu_torch.parallel import health as TH  # noqa: E402
from cueball_tpu_torch.parallel.mesh import Mesh, unshard  # noqa: E402

import chip_smoke  # noqa: E402
from conftest import run_async  # noqa: E402

CPU = 'cpu'
N = 8
INT_VERDICTS = ('gray', 'score', 'epoch')
# Fleet columns that do not read `score`: exact on every tick.
EXACT_FLEET = ('n_backends', 'ops', 'errors', 'shed', 'alert_page',
               'alert_ticket')
# Fleet columns that read `score`: exact when no backend lies on its
# rounding boundary, else within how far that many +-1 flips of `score`
# can move each.
SCORE_FLEET = ('median_score', 'mad_score', 'n_gray')
FLOAT_FLEET = ('claim_p99_ms', 'err_rate', 'over_frac', 'burn_fast',
               'burn_slow')
FORMS = ('plain', 'mesh')
FUZZ_SEEDS = range(6)
FUZZ_ROWS, FUZZ_TICKS, FUZZ_SHARE = 64, 4, 0.2


def jax_host():
    """The port's host seam over the JAX package's process state: its
    clock (read late, so a test's frozen clock applies), timer, backend
    registry and sinks, trace collector and loop-lag sampler."""
    return host.seam_over(mod_utils, mod_pool, mod_trace, mod_wiretap)


# -- stepping both packages -------------------------------------------------

def tick_cols(ms_by_row: dict, count: int = 10, errors: dict = None,
              claim_over: dict = None, now_ms: float = 1000.0,
              n=N) -> dict:
    """One tick where row r served `count` claims at ms_by_row[r] ms
    mean service latency (rows absent stay idle but eligible), as
    numpy columns."""
    cols = dict(
        lat_sum=np.zeros(n, np.float32), lat_count=np.zeros(n, np.int32),
        lat_buckets=np.zeros((n, JH.LAT_BINS), np.int32),
        claim_buckets=np.zeros((n, JH.LAT_BINS), np.int32),
        errors=np.zeros(n, np.int32), shed=np.zeros(n, np.int32),
        active=np.arange(n) >= 1, eligible=np.arange(n) >= 1,
        reset=np.zeros(n, bool), now_ms=np.float32(now_ms))
    for r, ms in ms_by_row.items():
        cols['lat_sum'][r] = ms * count
        cols['lat_count'][r] = count
        cols['lat_buckets'][r, JH.latency_bucket(ms)] += count
        cols['claim_buckets'][r, JH.latency_bucket(ms)] += count
    for r, e in (errors or {}).items():
        cols['errors'][r] = e
    for r, cnt in (claim_over or {}).items():
        cols['claim_buckets'][r, JH.LAT_BINS - 4] += cnt
    return cols


class Both:
    """A JAX health state and a port one, stepped in lockstep on the
    same columns; every step checks the port against JAX and returns
    the port's (verdicts, fleet) as numpy / Python values."""

    def __init__(self, n=N, objectives=None):
        self.jstep = (JH.health_step if objectives is None
                      else JH.make_health_step(objectives=objectives))
        self.tstep = (TH.health_step if objectives is None
                      else TH.make_health_step(objectives=objectives))
        self.jstate = JH.health_init(n)
        self.tstate = TH.health_init(n, device=CPU)
        self.edge_rows = 0

    def step(self, cols: dict):
        self.jstate, jv, jf = self.jstep(self.jstate,
                                         JH.health_inputs(len(cols['active']),
                                                          **cols))
        self.tstate, tv, tf = self.tstep(
            self.tstate, TH.health_inputs(len(cols['active']), device=CPU,
                                          **cols))
        tv = {k: v.numpy() for k, v in tv.items()}
        tf = to_host_values(tf)
        self.edge_rows += check_against_jax(tv, tf, jv, jf)
        return tv, tf


def check_against_jax(tv, tf, jv, jf, tag=''):
    """Hold port verdicts/fleet against JAX's; returns the number of
    backends on the score boundary."""
    edge = convert.health_score_near_boundary(np.asarray(jv['ewma_ms']))
    off = ~edge
    for name in INT_VERDICTS:
        want = np.asarray(jv[name])
        assert tv[name].dtype == want.dtype, (tag, name)
        if want.ndim:
            np.testing.assert_array_equal(tv[name][off], want[off],
                                          err_msg='%s %s' % (tag, name))
        else:
            assert tv[name] == want, (tag, name)
    for name in ('ewma_ms', 'z'):
        np.testing.assert_allclose(tv[name], np.asarray(jv[name]),
                                   rtol=1e-5, atol=1e-6,
                                   err_msg='%s %s' % (tag, name))
    want = {k: np.asarray(v).item() for k, v in jf.items()}
    n_edge = int(edge.sum())
    for name in EXACT_FLEET + SCORE_FLEET:
        assert type(tf[name]) is type(want[name]), (tag, name)
    for name in EXACT_FLEET:
        assert tf[name] == want[name], (tag, name)
    for name, slack in zip(SCORE_FLEET, score_fleet_slack(n_edge)):
        assert abs(tf[name] - want[name]) <= slack, (tag, name, n_edge)
    for name in FLOAT_FLEET:
        assert tf[name] == pytest.approx(want[name], rel=1e-5, abs=1e-6), (
            tag, name)
    return n_edge


def score_fleet_slack(n_edge: int) -> tuple:
    """How far median_score, mad_score and n_gray may move when n_edge
    backends' scores each flip by one: the median by at most one, each
    deviation by that plus its own flip, and each flipped backend's
    verdict."""
    if not n_edge:
        return (0, 0, 0)
    return (1, 2, n_edge)


HEALTHY = {r: 2.0 for r in range(1, N)}


# -- the law (tests/test_health.py, on both packages) -----------------------

def test_healthy_fleet_flags_nothing():
    b = Both()
    for _ in range(4):
        verdicts, fleet = b.step(tick_cols(HEALTHY))
    assert not verdicts['gray'].any()
    assert fleet['n_gray'] == 0
    assert fleet['n_backends'] == N - 1
    assert fleet['burn_fast'] == 0.0
    assert not fleet['alert_page']
    assert int(verdicts['epoch']) == 4
    assert b.edge_rows == 0


def test_gray_enters_after_streak_and_exits_after_clean_streak():
    slow = dict(HEALTHY)
    slow[7] = 400.0
    b = Both()
    for _ in range(2):
        b.step(tick_cols(HEALTHY))
    entered_at = None
    for i in range(1, TH.ENTER_STREAK + 2):
        verdicts, _ = b.step(tick_cols(slow))
        if verdicts['gray'][7] and entered_at is None:
            entered_at = i
    assert entered_at == TH.ENTER_STREAK
    assert verdicts['gray'].sum() == 1

    gray_ticks = 0
    for _ in range(60):
        verdicts, _ = b.step(tick_cols(HEALTHY))
        if verdicts['gray'][7]:
            gray_ticks += 1
        else:
            break
    assert gray_ticks >= TH.EXIT_STREAK
    assert not verdicts['gray'][7]
    assert b.edge_rows == 0


def test_unattributed_row_never_flags_gray():
    b = Both()
    for _ in range(6):
        cols = tick_cols(HEALTHY)
        # Hammer row 0 (the reserved unattributed bucket) with awful
        # latency; eligible[0] stays False.
        cols['lat_sum'][0] = 5000.0
        cols['lat_count'][0] = 10
        cols['active'][0] = True
        verdicts, fleet = b.step(cols)
    assert not verdicts['gray'][0]
    # ...but its traffic still feeds the fleet SLO columns.
    assert fleet['ops'] > (N - 1) * 10
    assert b.edge_rows == 0


def test_small_baseline_never_flags():
    b = Both()
    for _ in range(6):
        cols = tick_cols({1: 2.0, 2: 900.0})
        elig = np.zeros(N, bool)
        elig[1] = elig[2] = True
        cols['eligible'] = elig
        cols['active'] = elig.copy()
        verdicts, _ = b.step(cols)
    assert not verdicts['gray'].any()
    assert b.edge_rows == 0


def test_slo_error_burn_pages_and_tickets():
    b = Both()
    bad = tick_cols(HEALTHY, count=9, errors={r: 1 for r in range(1, N)})
    _, fleet = b.step(bad)
    assert fleet['err_rate'] == pytest.approx(0.1)
    assert fleet['burn_fast'] > TH.FAST_BURN_ALERT
    assert fleet['alert_page'] is True
    assert fleet['alert_ticket'] is False
    for _ in range(8):
        _, fleet = b.step(bad)
    assert fleet['alert_ticket'] is True
    assert b.edge_rows == 0


def test_slo_latency_burn_and_p99():
    b = Both()
    _, fleet = b.step(tick_cols({}, claim_over={r: 25 for r in range(1, N)}))
    assert fleet['over_frac'] == pytest.approx(1.0)
    assert fleet['burn_fast'] > TH.FAST_BURN_ALERT
    assert fleet['alert_page']
    assert fleet['claim_p99_ms'] > TH.DEFAULT_OBJECTIVES.claim_p99_ms

    _, fleet2 = Both().step(tick_cols(HEALTHY))
    k = TH.latency_bucket(2.0)
    upper = 2.0 ** ((k + 1) / TH.BUCKET_SCALE) - 1.0
    assert fleet2['claim_p99_ms'] == pytest.approx(upper)


def test_objectives_are_fixed_per_step_and_memoized():
    tight = TH.SLOObjectives(success_target=0.5, claim_p99_ms=250.0)
    assert tight == JH.SLOObjectives(success_target=0.5, claim_p99_ms=250.0)
    b = Both(objectives=tight)
    _, fleet = b.step(tick_cols(HEALTHY, count=10,
                                errors={r: 10 for r in range(1, N)}))
    # 50% errors exactly meets a 50% budget: burn 1.0, no page.
    assert fleet['burn_fast'] <= 1.0
    assert not fleet['alert_page']
    step = TH.make_health_step(objectives=tight)
    assert TH.make_health_step(objectives=tight) is step
    assert TH.make_health_step() is not step
    # The mesh form exists: a 2-shard CPU mesh steps a sharded state.
    mesh = Mesh([CPU] * 2, ('pools',))
    states, verdicts, fleet = TH.make_health_step(mesh=mesh)(
        TH.shard_health_state(TH.health_init(8, device=CPU), mesh),
        TH.shard_health_inputs(TH.health_inputs(8, device=CPU), mesh))
    assert [s.lat_hist.shape for s in states] == [(4, TH.LAT_BINS)] * 2
    assert [int(f['n_gray']) for f in fleet] == [0, 0]


def test_seeded_run_matches_jax_at_2048_backends():
    """Ten ticks of seeded traffic over 2,048 backends, 1% of them
    40x slow, with errors, sheds, idle and reset rows: verdicts exact
    off the score boundary, floats to rtol 1e-5, gray judged."""
    rng = np.random.default_rng(21)
    n = 2048
    slow = rng.random(n) < 0.01
    b = Both(n=n)
    grays = 0
    for t in range(10):
        lat = rng.gamma(2.0, 4.0, n).astype(np.float32)
        lat[slow] *= 40.0
        cnt = rng.integers(0, 20, n).astype(np.int32)
        buckets = np.zeros((n, JH.LAT_BINS), np.int32)
        bk = np.minimum((np.log2(1.0 + lat) * 4).astype(np.int32),
                        JH.LAT_BINS - 1)
        buckets[np.arange(n), bk] = cnt
        act = rng.random(n) < 0.95
        elig = act.copy()
        elig[0] = False
        verdicts, fleet = b.step(dict(
            lat_sum=lat * cnt, lat_count=cnt, lat_buckets=buckets,
            claim_buckets=buckets,
            errors=(rng.random(n) < 0.02).astype(np.int32),
            shed=(rng.random(n) < 0.01).astype(np.int32),
            active=act, eligible=elig, reset=rng.random(n) < 0.01,
            now_ms=np.float32(200.0 * (t + 1))))
        grays += int(verdicts['gray'].sum())
    assert grays > 0
    assert fleet['ops'] > 0
    # The backends on the score boundary in this seeded run.
    assert b.edge_rows == 3


def test_state_and_inputs_carry_across_from_jax():
    rng = np.random.default_rng(22)
    j_state = JH.health_init(N, epoch=5)
    j_state = j_state._replace(ewma_ms=jax.numpy.asarray(
        rng.uniform(1, 20, N).astype(np.float32)))
    j_inp = JH.health_inputs(N, **tick_cols(HEALTHY))
    host = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    t_state = convert.health_state_from_numpy(host(j_state), device=CPU)
    t_inp = convert.health_inputs_from_numpy(host(j_inp), device=CPU)
    assert t_state.gray_streak.dtype == torch.int32
    assert t_inp.lat_buckets.dtype == torch.int32
    _, jv, jf = JH.health_step(j_state, j_inp)
    _, tv, tf = TH.health_step(t_state, t_inp)
    edge = check_against_jax({k: v.numpy() for k, v in tv.items()},
                             to_host_values(tf), jv, jf)
    assert edge == 0
    assert int(tv['epoch']) == 6


def test_score_boundary_mask():
    # 16*log2(1+e) = k + 0.5 exactly at e = 2**((k+0.5)/16) - 1.
    on = 2.0 ** (40.5 / 16.0) - 1.0
    mask = convert.health_score_near_boundary(
        np.array([on, on * (1 + 1e-3), 1.0, 0.0]))
    assert mask.tolist() == [True, False, False, False]


def test_defaults_to_cuda():
    if torch.cuda.is_available():
        assert TH.health_init(4).ewma_ms.device.type == 'cuda'
        assert TH.HealthMonitor().hm_device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='CUDA'):
            TH.health_init(4)
        with pytest.raises(RuntimeError, match='CUDA'):
            TH.HealthMonitor()
    # The mesh option exists: rows round up to a multiple of the mesh.
    mesh = Mesh([CPU] * 2, ('pools',))
    mon = TH.HealthMonitor({'mesh': mesh})
    assert mon.hm_mesh is mesh and mon.hm_device.type == 'cpu'
    assert mon._rows_for(3) == 8 and mon._rows_for(9) == 16
    rec = mon.tick(1000.0)
    assert rec['epoch'] == 1 and len(mon.hm_state) == 2


# -- host edge: table, monitor, reduce (tests/test_health.py) ---------------

def test_backend_table_accumulates_and_drains():
    tbl = TH.BackendTable(host=mod_trace)
    tbl.observe('be-a', 10.0, 12.0, True)
    tbl.observe('be-a', 30.0, 31.0, True)
    tbl.observe('be-b', None, 50.0, False)
    tbl.observe_shed('be-b')
    tbl.observe('', 1.0, 1.0, True)      # unattributed bucket
    ra = mod_trace.backend_index('be-a')
    rb = mod_trace.backend_index('be-b')
    cols = tbl.drain()
    assert cols['lat_sum'][ra] == pytest.approx(40.0)
    assert cols['lat_count'][ra] == 2
    assert cols['errors'][rb] == 1
    assert cols['shed'][rb] == 1
    assert cols['lat_count'][0] == 1
    assert cols['active'][0] and not cols['eligible'][0]
    assert cols['eligible'][ra] and cols['eligible'][rb]
    assert cols['reset'][ra] and cols['reset'][rb]
    cols2 = tbl.drain()
    assert cols2['lat_sum'][ra] == 0.0          # drained atomically
    assert not cols2['reset'][ra]
    assert cols2['eligible'][ra]                # seen stays sticky


def test_backend_table_drains_like_jax():
    """The same observations into a JAX table and a port table over
    one registry drain to identical columns."""
    jt, tt = JH.BackendTable(), TH.BackendTable(host=mod_trace)
    rng = np.random.default_rng(23)
    for _ in range(200):
        key = 'be-drain-%d' % rng.integers(0, 12)
        ok = bool(rng.random() < 0.9)
        args = (key, float(rng.uniform(0, 300)) if ok else None,
                float(rng.uniform(0, 400)), ok)
        jt.observe(*args)
        tt.observe(*args)
        if rng.random() < 0.05:
            jt.observe_shed(key)
            tt.observe_shed(key)
    jc, tc = jt.drain(), tt.drain()
    assert sorted(jc) == sorted(tc)
    for name in jc:
        assert tc[name].dtype == jc[name].dtype, name
        np.testing.assert_array_equal(tc[name], jc[name], err_msg=name)


def test_monitor_ticks_grows_and_publishes_gauges():
    collector = mod_metrics.create_collector()
    mon = TH.HealthMonitor({'collector': collector, 'shard': 3,
                            'host': jax_host(), 'device': CPU}).start()
    try:
        assert mon in TH.active_monitors()
        assert mon.hm_table in mod_trace._BACKEND_SINKS
        for _ in range(40):
            mon.hm_table.observe('be-mon-a', 2.0, 3.0, True)
            mon.hm_table.observe('be-mon-b', 2.0, 3.0, True)
        rec = mon.tick(now_ms=1000.0)
        assert rec['epoch'] == 1
        assert rec['backends']['be-mon-a']['ewma_ms'] == pytest.approx(2.0)
        rows_before = mon.hm_rows

        # Force table growth past the padded state: the carried state
        # pads forward instead of restarting.
        for i in range(rows_before + 4):
            mon.hm_table.observe('be-mon-grow-%d' % i, 2.0, 3.0, True)
        rec = mon.tick(now_ms=2000.0)
        assert mon.hm_rows > rows_before
        assert rec['epoch'] == 2
        assert rec['backends']['be-mon-a']['ewma_ms'] > 0.0  # survived

        text = collector.collect()
        assert 'cueball_backend_health{backend="be-mon-a",shard="3"}' in text
        assert 'cueball_backend_latency_ewma_ms' in text
        assert 'objective="success",shard="3",window="fast"' in text
        assert 'window="slow"' in text

        snap = mon.snapshot()
        assert snap['objectives']['success_target'] == \
            TH.DEFAULT_OBJECTIVES.success_target
        assert snap['last']['epoch'] == 2
        assert len(snap['history']) == 2
        assert TH.health_snapshot()['n_monitors'] >= 1
    finally:
        mon.stop()
    assert mon not in TH.active_monitors()
    assert mon.hm_table not in mod_trace._BACKEND_SINKS


def assert_records_match(trec, jrec):
    """A port monitor's published record equals the JAX monitor's:
    verdicts exactly, floats to rtol 1e-5."""
    assert trec['epoch'] == jrec['epoch']
    assert trec['gray'] == jrec['gray']
    assert sorted(trec['backends']) == sorted(jrec['backends'])
    for key, jb in jrec['backends'].items():
        tb = trec['backends'][key]
        assert (tb['gray'], tb['score']) == (jb['gray'], jb['score'])
        assert tb['ewma_ms'] == pytest.approx(jb['ewma_ms'], rel=1e-5)
    for key, v in jrec['fleet'].items():
        assert type(trec['fleet'][key]) is type(v), key
        assert trec['fleet'][key] == pytest.approx(v, rel=1e-5), key


def test_monitor_records_match_jax_monitor():
    """A JAX HealthMonitor and a port one, fed the same claims through
    the JAX trace layer's sinks, publish equal records tick by tick."""
    host = jax_host()
    jmon = JH.HealthMonitor().start()
    tmon = TH.HealthMonitor({'host': host, 'device': CPU}).start()
    rng = np.random.default_rng(24)
    try:
        for t in range(6):
            for _ in range(60):
                key = 'be-rec-%d' % rng.integers(0, 10)
                ms = float(rng.uniform(1, 8)) * (30.0 if key == 'be-rec-3'
                                                 else 1.0)
                ok = bool(rng.random() < 0.97)
                for sink in mod_trace._BACKEND_SINKS:
                    if sink in (jmon.hm_table, tmon.hm_table):
                        sink.observe(key, ms if ok else None, ms + 1.0, ok)
            now = 1000.0 * (t + 1)
            jrec, trec = jmon.tick(now_ms=now), tmon.tick(now_ms=now)
            assert_records_match(trec, jrec)
        assert jrec['gray'] == ['be-rec-3']
    finally:
        jmon.stop()
        tmon.stop()


def test_reduce_health_merges_shard_verdicts():
    a = {'epoch': 3, 'at_ms': 1.0, 'gray': ['be-x'], 'backends': {},
         'fleet': {'n_backends': 4, 'n_gray': 1, 'ops': 100,
                   'errors': 10, 'shed': 1, 'err_rate': 0.1,
                   'claim_p99_ms': 40.0, 'burn_fast': 2.0,
                   'burn_slow': 1.0, 'alert_page': False,
                   'alert_ticket': True}}
    b = {'epoch': 5, 'at_ms': 2.0, 'gray': ['be-y'], 'backends': {},
         'fleet': {'n_backends': 2, 'n_gray': 1, 'ops': 300,
                   'errors': 0, 'shed': 0, 'err_rate': 0.0,
                   'claim_p99_ms': 90.0, 'burn_fast': 20.0,
                   'burn_slow': 0.5, 'alert_page': True,
                   'alert_ticket': False}}
    fleet = TH.reduce_health([a, None, b])
    assert fleet == JH.reduce_health([a, None, b])
    assert fleet['gray'] == ['be-x', 'be-y']
    assert fleet['n_backends'] == 6 and fleet['ops'] == 400
    assert fleet['err_rate'] == pytest.approx(10 / 400)
    assert fleet['claim_p99_ms'] == 90.0
    assert fleet['burn_fast'] == 20.0 and fleet['burn_slow'] == 1.0
    assert fleet['alert_page'] and fleet['alert_ticket']
    empty = TH.reduce_health([])
    assert empty['n_backends'] == 0 and empty['gray'] == []
    assert not empty['alert_page']


def test_claim_to_verdict_end_to_end():
    """A real pool claim attributes through the JAX trace layer into the
    port's monitor: the verdict record names the pool's backend key."""
    import asyncio

    from test_debug import build_pool, settle

    async def t():
        mod_trace.enable_tracing(ring_size=64, sample_rate=1.0)
        mon = TH.HealthMonitor({'host': jax_host(), 'device': CPU}).start()
        try:
            pool, _ = build_pool()
            await settle(pool)
            fut = asyncio.get_running_loop().create_future()

            def cb(err, hdl=None, conn=None):
                fut.set_result((err, hdl))
            pool.claim_cb({'timeout': 1000}, cb)
            err, hdl = await fut
            assert err is None
            # Hold the lease for a beat so the service span has a
            # strictly positive duration.
            await asyncio.sleep(0.005)
            hdl.release()
            await asyncio.sleep(0.02)
            rec = mon.tick()
            key = pool.p_keys[0]
            assert key in rec['backends'], sorted(rec['backends'])
            assert rec['fleet']['ops'] >= 1
            pool.stop()
        finally:
            mon.stop()
            mod_trace.disable_tracing()
    run_async(t())


# -- non-finite and out-of-range inputs -------------------------------------

def port_ticks(form, n, ticks):
    """The port's health step from ``health_init(n)`` on the CPU over
    each tick's numpy columns, plain or over a 2-shard mesh; yields each
    tick's (state, verdicts as numpy, fleet as host values)."""
    if form == 'plain':
        step, state = TH.health_step, TH.health_init(n, device=CPU)
    else:
        mesh = Mesh([CPU] * 2, ('pools',))
        step = TH.make_health_step(mesh)
        state = TH.shard_health_state(TH.health_init(n, device=CPU), mesh)
    for cols in ticks:
        inp = TH.health_inputs(n, device=CPU, **cols)
        if form == 'plain':
            state, verdicts, fleet = step(state, inp)
            flat = state
        else:
            state, verdicts, fleet = step(
                state, TH.shard_health_inputs(inp, mesh))
            flat, verdicts, fleet = unshard(state), unshard(verdicts), fleet[0]
        yield (flat, {k: v.numpy() for k, v in verdicts.items()},
               to_host_values(fleet))


@pytest.fixture(scope='module')
def jax_ticks():
    """The JAX health step's ticks from ``health_init`` over a list of
    numpy columns, as numpy, memoized by key for the module."""
    memo = {}

    def run(key, ticks):
        if key not in memo:
            state = JH.health_init(len(ticks[0]['active']))
            out = []
            for cols in ticks:
                state, verdicts, fleet = JH.health_step(
                    state, JH.health_inputs(len(cols['active']), **cols))
                out.append(jax.tree.map(np.asarray, (state, verdicts, fleet)))
            memo[key] = out
        return memo[key]
    return run


@pytest.mark.parametrize('form', FORMS)
@pytest.mark.parametrize('name,lat_sum', chip_smoke.NONFINITE_LAT_SUMS,
                         ids=[n for n, _ in chip_smoke.NONFINITE_LAT_SUMS])
def test_nonfinite_lat_sum_rows_match_jax(name, lat_sum, form, jax_ticks):
    """A mean below -1 ms, NaN or +inf makes ``log2(1 + ewma)`` NaN or
    infinite: the score saturates as the JAX package's does (NaN to 0),
    and the step goes on. The JAX numbers are chip_smoke.py's."""
    ticks = [chip_smoke.nonfinite_health_columns(lat_sum)]
    (_, jv, jf), = jax_ticks(name, ticks)
    (_, tv, tf), = port_ticks(form, len(lat_sum), ticks)
    assert check_against_jax(tv, tf, jv, jf, name) == 0
    assert jv['score'].tolist() == chip_smoke.JAX_NONFINITE_SCORES[name]
    np.testing.assert_array_equal(tv['score'], jv['score'])
    np.testing.assert_array_equal(tv['gray'], jv['gray'])
    for key, frozen in chip_smoke.JAX_NONFINITE_HEALTH_FLEET.items():
        assert tf[key] == jf[key].item() == frozen, key


def fuzz_ticks(seed):
    """FUZZ_TICKS ticks of seeded traffic over FUZZ_ROWS backends with
    FUZZ_SHARE of every ``lat_sum`` replaced by NaN, +-inf, -5, +-4e9, 0
    or 1e-30."""
    rng = np.random.default_rng(seed)
    n, ticks = FUZZ_ROWS, []
    for t in range(FUZZ_TICKS):
        lat = rng.gamma(2.0, 4.0, n).astype(np.float32)
        cnt = rng.integers(0, 20, n).astype(np.int32)
        buckets = np.zeros((n, JH.LAT_BINS), np.int32)
        bk = np.minimum((np.log2(1.0 + lat) * 4).astype(np.int32),
                        JH.LAT_BINS - 1)
        buckets[np.arange(n), bk] = cnt
        act = rng.random(n) < 0.9
        elig = act.copy()
        elig[0] = False
        ticks.append(dict(
            lat_sum=chip_smoke.with_specials(rng, lat * cnt, FUZZ_SHARE),
            lat_count=cnt, lat_buckets=buckets, claim_buckets=buckets,
            errors=(rng.random(n) < 0.05).astype(np.int32),
            shed=(rng.random(n) < 0.02).astype(np.int32), active=act,
            eligible=elig, reset=rng.random(n) < 0.05,
            now_ms=np.float32(200.0 * (t + 1))))
    return ticks


@pytest.mark.parametrize('form', FORMS)
@pytest.mark.parametrize('seed', FUZZ_SEEDS)
def test_nonfinite_fuzz_matches_jax(seed, form, jax_ticks):
    """Four chained ticks: verdicts, the fleet row and the carried
    state agree with the JAX package's on every tick."""
    ticks = fuzz_ticks(seed)
    want = jax_ticks('fuzz %d' % seed, ticks)
    nan_ewma = 0
    for t, ((ts, tv, tf), (js, jv, jf)) in enumerate(
            zip(port_ticks(form, FUZZ_ROWS, ticks), want)):
        tag = 'seed %d tick %d' % (seed, t)
        assert check_against_jax(tv, tf, jv, jf, tag) == 0
        for name in ('gray_streak', 'ok_streak', 'gray', 'epoch'):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          getattr(js, name), err_msg=tag)
        for name in ('ewma_ms', 'lat_hist'):
            np.testing.assert_allclose(getattr(ts, name).numpy(),
                                       getattr(js, name), rtol=1e-5,
                                       atol=1e-6, err_msg=tag)
        nan_ewma += int(np.isnan(jv['ewma_ms']).sum())
    assert nan_ewma > 0


def test_monitor_with_negative_service_time_matches_jax():
    """A backend whose claims report a service time of -5 ms (a clock
    that stepped back) has a NaN score float: the port's monitor bins
    it as the JAX one does and judges the rest of the fleet."""
    host = jax_host()
    jmon = JH.HealthMonitor().start()
    tmon = TH.HealthMonitor({'host': host, 'device': CPU}).start()
    try:
        for t in range(2):
            for i in range(48):
                key = 'be-neg-%d' % (i % 8)
                ms = -5.0 if key == 'be-neg-3' else 2.0 + i % 8
                for sink in mod_trace._BACKEND_SINKS:
                    if sink in (jmon.hm_table, tmon.hm_table):
                        sink.observe(key, ms, abs(ms) + 1.0, True)
            now = 1000.0 * (t + 1)
            jrec, trec = jmon.tick(now_ms=now), tmon.tick(now_ms=now)
            assert_records_match(trec, jrec)
        assert trec['epoch'] == 2
        assert 'be-neg-3' not in trec['backends']
        assert sorted(trec['backends']) == ['be-neg-%d' % i
                                            for i in (0, 1, 2, 4, 5, 6, 7)]
    finally:
        jmon.stop()
        tmon.stop()
