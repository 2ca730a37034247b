"""The port's host surfaces against the JAX package's, on the CPU:
``/kang/health``, ``/kang/fleet``, ``/kang/profile`` and
``/kang/shards`` (``http_server``), the SIGUSR2 section and the failure
record (``debug``), and the loop-lag sampler (``host``).

A JAX ``HealthMonitor`` and a port one (through ``host.seam_over``)
are fed the same claims through the JAX trace layer's sinks, each the
only active monitor of its package, so the two packages' surfaces
describe matched monitors: gray sets identical, floats within rtol
1e-5, verdicts exactly off ``convert.health_score_near_boundary``
(the test asserts no backend lies on it).
"""

import asyncio
import http.client
import json
import logging
import os
import signal
import threading
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')

from cueball_tpu import debug as jdebug  # noqa: E402
from cueball_tpu import http_server as jhttp  # noqa: E402
from cueball_tpu import profile as jprofile  # noqa: E402
from cueball_tpu import trace as mod_trace  # noqa: E402
from cueball_tpu import utils as mod_utils  # noqa: E402
from cueball_tpu import wiretap as mod_wiretap  # noqa: E402
from cueball_tpu.parallel import health as JH  # noqa: E402
from cueball_tpu_torch import convert, debug, host  # noqa: E402
from cueball_tpu_torch import utils as t_utils  # noqa: E402
from cueball_tpu_torch import wiretap as t_wiretap  # noqa: E402
from cueball_tpu_torch import http_server as thttp  # noqa: E402
from cueball_tpu_torch import profile as tprofile  # noqa: E402
from cueball_tpu_torch import trace as ttrace  # noqa: E402
from cueball_tpu_torch.monitor import PoolMonitor  # noqa: E402
from cueball_tpu_torch.parallel import health as TH  # noqa: E402
from cueball_tpu_torch.parallel.sampler import FleetSampler  # noqa: E402
from cueball_tpu_torch.entry import SyntheticPool  # noqa: E402

from conftest import run_async  # noqa: E402
from test_torch_health import jax_host  # noqa: E402

CPU = 'cpu'


@pytest.fixture
def matched_monitors():
    """One JAX and one port HealthMonitor, each its package's only
    active monitor (others are set aside and put back after), fed the
    same claims for six ticks; ``be-sf-3`` is 30x slow, so gray."""
    saved = (JH._MONITORS[:], TH._MONITORS[:])
    JH._MONITORS.clear()
    TH._MONITORS.clear()
    jmon = JH.HealthMonitor({'shard': 1}).start()
    tmon = TH.HealthMonitor({'shard': 1, 'host': jax_host(),
                             'device': CPU}).start()
    rng = np.random.default_rng(52)
    try:
        for t in range(6):
            for _ in range(60):
                key = 'be-sf-%d' % rng.integers(0, 8)
                ms = float(rng.uniform(1, 8)) * (30.0 if key == 'be-sf-3'
                                                 else 1.0)
                ok = bool(rng.random() < 0.97)
                for sink in mod_trace._BACKEND_SINKS:
                    if sink in (jmon.hm_table, tmon.hm_table):
                        sink.observe(key, ms if ok else None, ms + 1.0, ok)
            now = 1000.0 * (t + 1)
            jmon.tick(now_ms=now)
            tmon.tick(now_ms=now)
        edge = convert.health_score_near_boundary(np.float32(
            [b['ewma_ms'] for b in jmon.hm_last['backends'].values()]))
        assert not edge.any()
        assert jmon.hm_last['gray'] == ['be-sf-3']
        yield jmon, tmon
    finally:
        jmon.stop()
        tmon.stop()
        JH._MONITORS[:] = saved[0]
        TH._MONITORS[:] = saved[1]


def assert_same(got, want, path=''):
    """Two JSON trees equal: the same keys and types, numbers to rtol
    1e-5, everything else exactly."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], '%s/%s' % (path, k))
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, '%s[%d]' % (path, i))
    elif isinstance(want, float):
        assert isinstance(got, float), path
        assert got == pytest.approx(want, rel=1e-5, abs=1e-6), path
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize('query', ['', '?limit=1', '?limit=0'])
def test_kang_health_matches_jax(matched_monitors, query):
    want = jhttp._route('GET', '/kang/health' + query, None)
    got = thttp.route('GET', '/kang/health' + query)
    assert got[:2] == want[:2] == (200, 'application/json')
    body, jbody = json.loads(got[2]), json.loads(want[2])
    assert_same(body, jbody)
    assert body['n_monitors'] == 1
    assert len(body['monitors']) == (0 if query == '?limit=0' else 1)
    assert body['fleet']['gray'] == ['be-sf-3']


@pytest.mark.parametrize('method,path', [
    ('GET', '/kang/health?bogus=1'),
    ('GET', '/kang/health?limit=x'),
    ('GET', '/kang/health?limit=-1'),
    ('POST', '/kang/health'),
    ('GET', '/kang/nowhere'),
])
def test_kang_errors_match_jax(method, path):
    """400 with a JSON body for a bad parameter, 405 for a method other
    than GET, 404 for an unknown path: byte for byte the JAX route's."""
    assert thttp.route(method, path) == jhttp._route(method, path, None)


@pytest.mark.parametrize('query', ['', '?phase=lease', '?phase=other',
                                   '?phase=nope', '?phase=', '?limit=1',
                                   '?phase=lease&bogus=1'])
def test_kang_profile_matches_jax(query):
    """With both profilers idle, every answer (the empty flamegraph, and
    the 400s for an unknown phase or parameter) is the JAX route's, byte
    for byte."""
    for prof, trace in ((jprofile, mod_trace), (tprofile, ttrace)):
        prof.stop_sampler()
        prof.reset_samples()
        trace.disable_tracing()
    want = jhttp._route('GET', '/kang/profile' + query, None)
    assert thttp.route('GET', '/kang/profile' + query) == want
    assert want[0] == (200 if query in ('', '?phase=lease', '?phase=other')
                       else 400)


def test_kang_shards_matches_jax():
    """One started inline router in each package, owning the same
    pools: ``/kang/shards`` gives the same body."""
    from test_torch_shard import JAX, PORT, started, stopped

    async def t():
        names = ['svc.ks%d' % i for i in range(4)]
        routers = [await started(pkg, names, shards=3, backend='inline')
                   for pkg in (JAX, PORT)]
        try:
            want = jhttp._route('GET', '/kang/shards', None)
            got = thttp.route('GET', '/kang/shards')
        finally:
            for r in routers:
                await stopped(r)
        assert got == want and want[0] == 200
        (only,) = json.loads(got[2])['routers']
        assert sorted(only['pools']) == names and only['nshards'] == 3
        assert thttp.route('GET', '/kang/shards')[2] == b'{"routers": []}'
    run_async(t())


def test_kang_fleet_shows_the_attached_sampler():
    mon = PoolMonitor()
    for i in range(3):
        mon.register_pool(SyntheticPool(i))
    assert json.loads(thttp.route('GET', '/kang/fleet', mon)[2]) == {
        'attached': False}
    sampler = FleetSampler({'monitor': mon, 'device': CPU})
    sampler.sample_once()
    mon.attach_fleet_sampler(sampler)
    status, ctype, body = thttp.route('GET', '/kang/fleet', mon)
    snap = json.loads(body)
    assert (status, ctype) == (200, 'application/json')
    assert snap['attached'] and snap['ticks'] == 1
    assert sorted(snap['latest']['pools']) == sorted(mon.pm_pools)
    sampler.stop()


def test_serve_monitor_fetched_from_a_thread(matched_monitors):
    """The server on the test's loop, fetched from a thread (a blocking
    client on the serving loop would deadlock): the health body equals
    route()'s, keep-alive serves three requests on one connection,
    and a 404 and a 405 come back as such."""
    async def t():
        server = await thttp.serve_monitor()
        port = server.sockets[0].getsockname()[1]
        base = 'http://127.0.0.1:%d' % port

        def fetch():
            with urllib.request.urlopen(base + '/kang/health') as r:
                body = r.read()
            conn = http.client.HTTPConnection('127.0.0.1', port, timeout=10)
            statuses = []
            for method, path in (('GET', '/kang/health?limit=1'),
                                 ('POST', '/kang/health'),
                                 ('GET', '/kang/nowhere')):
                conn.request(method, path)
                resp = conn.getresponse()
                resp.read()
                statuses.append(resp.status)
            conn.close()
            return body, statuses

        try:
            body, statuses = await asyncio.to_thread(fetch)
        finally:
            server.close()
            await server.wait_closed()
        assert json.loads(body) == json.loads(
            thttp.route('GET', '/kang/health')[2])
        assert statuses == [200, 405, 404]
    run_async(t())


def test_health_section_matches_jax(matched_monitors):
    text = debug.health_section()
    assert text == jdebug._health_section()
    assert '   gray be-sf-3' in text
    TH._MONITORS.clear()
    assert debug.health_section() == ''


def test_dump_fleet_runtime_lists_samplers_then_health(matched_monitors):
    mon = PoolMonitor()
    mon.register_pool(SyntheticPool(0))
    sampler = FleetSampler({'monitor': mon, 'device': CPU, 'shard': 2})
    sampler.sample_once()
    try:
        report = debug.dump_fleet_runtime()
        line = ('  fleet_sampler device=cpu pools=0 shard=2 ticks=1')
        assert line in report.splitlines()
        assert report.endswith(debug.health_section())
    finally:
        sampler.stop()
    assert line not in debug.dump_fleet_runtime()


def test_health_record_has_the_failure_dump_shape(matched_monitors):
    """The `health` entry netsim's failure dump embeds
    (netsim/scenario.py:158-173), for the same monitors."""
    jmon, tmon = matched_monitors
    want = {'fleet': JH.reduce_health([jmon.hm_last]),
            'history': [list(jmon.hm_history)]}
    assert_same(json.loads(json.dumps(debug.health_record())),
                json.loads(json.dumps(want)))
    TH._MONITORS.clear()
    assert debug.health_record() is None


def test_debug_handler_chains_to_the_jax_handler(caplog):
    """One SIGUSR2 runs the port's handler and the JAX package's handler
    it was installed over: each toggles its own package's stack capture
    (the second signal toggles both back) and logs its own dump."""
    jprev = jdebug.install_debug_handler(signal.SIGUSR2)
    prev = debug.install_debug_handler(signal.SIGUSR2)
    try:
        assert prev is jdebug._on_debug_signal
        with caplog.at_level(logging.WARNING, logger='cueball.debug'):
            os.kill(os.getpid(), signal.SIGUSR2)
            assert mod_utils.stack_traces_enabled()
            assert t_utils.stack_traces_enabled()
            os.kill(os.getpid(), signal.SIGUSR2)
            assert not mod_utils.stack_traces_enabled()
            assert not t_utils.stack_traces_enabled()
    finally:
        debug.uninstall_debug_handler(prev, signal.SIGUSR2)
        jdebug.uninstall_debug_handler(jprev, signal.SIGUSR2)
        mod_utils.disable_stack_traces()
        t_utils.disable_stack_traces()
    assert signal.getsignal(signal.SIGUSR2) == jprev
    by_package = [os.path.basename(os.path.dirname(r.pathname))
                  for r in caplog.records
                  if 'stack traces now' in r.getMessage()]
    assert by_package == ['cueball_tpu_torch', 'cueball_tpu'] * 2


@pytest.fixture
def lag_samplers():
    """Both packages' loop-lag registries, emptied before and after."""
    def clear():
        mod_wiretap.stop_loop_lag_sampler()
        host.stop_loop_lag_sampler()
        mod_wiretap._lag_samplers.clear()
        host._lag_samplers.clear()
        mod_wiretap._lag_disabled_reason = None
        t_wiretap._lag_disabled_reason = None
    clear()
    yield
    clear()


def test_loop_lag_sampler_matches_wiretap(lag_samplers):
    async def t():
        assert host.loop_lag_p99_us() == 0.0
        assert host.start_loop_lag_sampler(interval_ms=5.0)
        assert mod_wiretap.start_loop_lag_sampler(interval_ms=5.0)
        assert host.start_loop_lag_sampler(interval_ms=5.0)   # idempotent
        await asyncio.sleep(0.1)
        got, want = host.loop_lag_stats(), mod_wiretap.loop_lag_stats()
        assert set(got) == set(want)
        assert got['samples'] > 0 and want['samples'] > 0
        assert got['running'] and got['disabled_reason'] is None
        assert got['ring'] == want['ring'] == host.DEFAULT_LAG_RING
        assert host.loop_lag_p99_us() == got['p99_us'] >= 0.0
        assert host.stop_loop_lag_sampler()
        assert not host.loop_lag_stats()['running']
    run_async(t())


def test_loop_lag_sampler_refuses_like_wiretap(lag_samplers):
    """Off the main thread, where no loop runs, and under a clock that
    is not the system's, both packages refuse with the same reason."""
    out = []
    th = threading.Thread(target=lambda: out.append((
        host.start_loop_lag_sampler(),
        host.loop_lag_stats()['disabled_reason'],
        mod_wiretap.start_loop_lag_sampler(),
        mod_wiretap.loop_lag_stats()['disabled_reason'])))
    th.start()
    th.join(10)
    assert not th.is_alive()
    assert out == [(False, 'no running event loop',
                    False, 'no running event loop')]

    class Virtual:
        def monotonic(self):
            return 1.0

        def wall(self):
            return 1.0

    async def t():
        jold = mod_utils.set_clock(Virtual())
        told = t_utils.set_clock(Virtual())
        try:
            assert host.current_millis() == 1000.0
            assert not host.start_loop_lag_sampler()
            assert not mod_wiretap.start_loop_lag_sampler()
            assert (host.loop_lag_stats()['disabled_reason'] ==
                    mod_wiretap.loop_lag_stats()['disabled_reason'])
        finally:
            t_utils.set_clock(told)
            mod_utils.set_clock(jold)
        assert host.start_loop_lag_sampler()
    run_async(t())
