"""The port's SIGUSR2 dump and live-attach tools (``cueball_tpu_torch.debug``)
against the JAX package's, on the CPU.

``dump_fsm_histories()`` runs over matched objects in each package (a
pool, a connection set, a DNS resolver and an inline router owning a
pool, each the only one of its kind in its package's monitor) and the
two reports agree line for line once pids, clocks, ids and dwell times
are masked. The ``LoopAffinityChecker`` flags a seeded off-thread claim
on a port pool as the JAX one flags it on a JAX pool, and finds nothing
over a thread router's claim loop. ``init_from_env`` applies both
variables and survives a bad signal name, as the JAX package's does.
"""

import asyncio
import logging
import os
import re
import signal
import threading
import types

import pytest

pytest.importorskip('torch')

import cueball_tpu as jcb  # noqa: E402
import cueball_tpu_torch as tcb  # noqa: E402
from cueball_tpu import debug as j_debug  # noqa: E402
from cueball_tpu import events as j_events  # noqa: E402
from cueball_tpu import monitor as j_monitor  # noqa: E402
from cueball_tpu import profile as j_profile  # noqa: E402
from cueball_tpu import shard as j_shard  # noqa: E402
from cueball_tpu import utils as j_utils  # noqa: E402
from cueball_tpu import wiretap as j_wiretap  # noqa: E402
from cueball_tpu.parallel import health as j_health  # noqa: E402
from cueball_tpu_torch import debug as t_debug  # noqa: E402
from cueball_tpu_torch import events as t_events  # noqa: E402
from cueball_tpu_torch import monitor as t_monitor  # noqa: E402
from cueball_tpu_torch import profile as t_profile  # noqa: E402
from cueball_tpu_torch import shard as t_shard  # noqa: E402
from cueball_tpu_torch import utils as t_utils  # noqa: E402
from cueball_tpu_torch import wiretap as t_wiretap  # noqa: E402
from cueball_tpu_torch.parallel import health as t_health  # noqa: E402
from cueball_tpu_torch.parallel import sampler as t_sampler  # noqa: E402

from conftest import run_async  # noqa: E402

JAX = types.SimpleNamespace(cb=jcb, debug=j_debug, events=j_events,
                            shard=j_shard, opts={})
PORT = types.SimpleNamespace(cb=tcb, debug=t_debug, events=t_events,
                             shard=t_shard, opts={'device': 'cpu'})
RECOVERY = {'default': {'timeout': 1000, 'retries': 1, 'delay': 50}}


@pytest.fixture
def alone():
    """Each package's monitor, health monitors, wire ledger and loop-lag
    samplers, and the port's samplers, emptied for the test and put back
    after; both profilers stopped. The dump prints the wire ledger's
    section when either is set, and a test that ran earlier in the same
    process (a bench stage, say) may have left them set in one package."""
    mons = (j_monitor.pool_monitor, t_monitor.pool_monitor)
    saved = [(m.pm_pools.copy(), m.pm_sets.copy(), m.pm_dns_res.copy())
             for m in mons]
    monitors = (j_health._MONITORS[:], t_health._MONITORS[:])
    samplers = dict(t_sampler._SAMPLERS)
    wires = [(w, w._LEDGER, dict(w._lag_samplers), w._lag_disabled_reason)
             for w in (j_wiretap, t_wiretap)]
    for m in mons:
        m.pm_pools.clear()
        m.pm_sets.clear()
        m.pm_dns_res.clear()
    j_health._MONITORS.clear()
    t_health._MONITORS.clear()
    t_sampler._SAMPLERS.clear()
    for w, *_ in wires:
        w._LEDGER = None
        w._lag_samplers.clear()
        w._lag_disabled_reason = None
    try:
        yield
    finally:
        for m, (pools, sets, res) in zip(mons, saved):
            m.pm_pools.update(pools)
            m.pm_sets.update(sets)
            m.pm_dns_res.update(res)
        j_health._MONITORS[:] = monitors[0]
        t_health._MONITORS[:] = monitors[1]
        t_sampler._SAMPLERS.update(samplers)
        for w, ledger, lag, reason in wires:
            w._LEDGER = ledger
            w._lag_samplers.clear()
            w._lag_samplers.update(lag)
            w._lag_disabled_reason = reason
        for prof in (j_profile, t_profile):
            prof.stop_sampler()
            prof.reset_samples()


def objects(pkg):
    """(pool factory, connection-set factory) over ``pkg``: connections
    that connect on the next loop turn."""
    class Conn(pkg.events.EventEmitter):
        def __init__(self, backend):
            super().__init__()
            asyncio.get_running_loop().call_soon(self.emit, 'connect')

        def destroy(self):
            pass

        def unref(self):
            pass

    def pool():
        res = pkg.cb.StaticIpResolver({'backends': [
            {'address': '127.0.0.1', 'port': 1111}]})
        p = pkg.cb.ConnectionPool({
            'domain': 'debug.test', 'resolver': res, 'constructor': Conn,
            'spares': 1, 'maximum': 2, 'recovery': RECOVERY})
        res.start()
        return p, res

    def cset():
        res = pkg.cb.StaticIpResolver({'backends': [
            {'address': '10.0.0.9', 'port': 5}]})
        s = pkg.cb.ConnectionSet({'constructor': Conn, 'resolver': res,
                                  'target': 1, 'maximum': 2,
                                  'recovery': RECOVERY})
        s.on('added', lambda key, conn, hdl: None)
        s.on('removed', lambda key, conn, hdl: hdl.release())
        res.start()
        return s, res
    return pool, cset


def _dump(pkg):
    async def main():
        make_pool, make_cset = objects(pkg)
        pool, pres = make_pool()
        cset, cres = make_cset()
        dns = pkg.cb.DNSResolver({'domain': 'dump.example',
                                  'service': '_x._tcp', 'defaultPort': 1,
                                  'recovery': RECOVERY})
        router = pkg.shard.FleetRouter(dict(pkg.opts, shards=2,
                                            backend='inline'))
        await router.start()
        await router.create_pool('svc.dump', factory=make_pool)
        routed = router.get_pool('svc.dump')
        while not (pool.is_in_state('running') and cset.is_in_state(
                'running') and routed.is_in_state('running')):
            await asyncio.sleep(0.005)
        await asyncio.sleep(0.05)
        report = pkg.debug.dump_fsm_histories()
        for obj in (pool, pres, cset, cres, dns):
            obj.stop()
        rec = router.fr_pools['svc.dump']
        await router.destroy_pool('svc.dump')
        rec.aux[0].stop()
        await router.stop()
        return report
    return run_async(main(), timeout=20.0)


def mask(report: str) -> list:
    """The report's lines with the pid, the clock, uuids and the
    dwell times masked."""
    out = []
    for line in report.splitlines():
        line = re.sub(r'pid=\d+ t=[\d.]+', 'pid=<pid> t=<t>', line)
        line = re.sub(r'[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-'
                      r'[0-9a-f]{12}', '<uuid>', line)
        out.append(re.sub(r'\(\d+ms\)', '(<n>ms)', line))
    return out


def test_dump_matches_jax_line_for_line(alone):
    want = mask(_dump(JAX))
    got = mask(_dump(PORT))
    assert got == want
    text = '\n'.join(want)
    for head in ('pool <uuid> domain=debug.test', 'set <uuid>',
                 'dns_res <uuid> domain=dump.example',
                 'fleet_router backend=inline shards=2',
                 '  shard 0        state=running'):
        assert head in text, head
    assert re.search(r'  pool svc\.dump +-> shard \d', text)


def test_dump_lists_the_ports_samplers_and_health(alone):
    """The port's part of the dump: a line per live fleet sampler, then
    the health section, between the router and the trace sections."""
    mon = t_monitor.PoolMonitor()
    s = t_sampler.FleetSampler({'monitor': mon, 'device': 'cpu',
                                'shard': 3, 'health': True})
    s.sample_once()
    try:
        report = t_debug.dump_fsm_histories()
        section = t_debug.health_section()
    finally:
        s.stop()
    lines = report.splitlines()
    at = lines.index('  fleet_sampler device=cpu pools=0 shard=3 ticks=1')
    assert lines[at + 1] == '-- fleet health (1 monitor(s)) --'
    assert section.startswith(lines[at + 1]) and section in report
    assert 'fleet_sampler' not in t_debug.dump_fsm_histories()


def _off_thread_claim(pkg):
    """A pool claimed on its loop's thread, then from another thread,
    under a checker watching it: the violations' kinds and sites."""
    lc = pkg.debug.LoopAffinityChecker()

    async def main():
        make_pool, _ = objects(pkg)
        pool, res = make_pool()
        while not pool.is_in_state('running'):
            await asyncio.sleep(0.005)
        with lc:
            lc.watch(pool, tag='pool')
            hdl, _conn = await pool.claim({'timeout': 1000})
            hdl.release()
            errors = []

            def off_thread():
                try:
                    pool.claim_cb({'timeout': 1000}, lambda *a: None)
                except RuntimeError as e:       # no loop on this thread
                    errors.append(str(e))
            th = threading.Thread(target=off_thread)
            th.start()
            th.join()
            assert errors == ['no running event loop']
            await asyncio.sleep(0.05)
        pool.stop()
        res.stop()
    run_async(main(), timeout=20.0)
    return [(v['kind'], v.get('method'),
             v['site'][0] if v.get('site') else None)
            for v in lc.violations]


def test_checker_flags_an_off_thread_claim_as_jax_does(alone):
    want = _off_thread_claim(JAX)
    got = _off_thread_claim(PORT)
    assert ('off_thread_call', 'claim_cb', None) in got
    assert [v[:2] for v in got] == [v[:2] for v in want]
    # The port's checker names the port's own files (the JAX checker's
    # scope is its package).
    assert [v[2] for v in got] == [v[2] for v in want]


def test_checker_finds_nothing_over_a_thread_router(alone):
    lc = t_debug.LoopAffinityChecker()
    make_pool, _ = objects(PORT)

    async def main():
        router = t_shard.FleetRouter({'shards': 2, 'backend': 'thread',
                                      'device': 'cpu'})
        await router.start()
        names = ['svc.lc%d' % i for i in range(4)]
        for name in names:
            await router.create_pool(name, factory=make_pool)
        with lc:
            for k in range(40):
                claim = await router.claim(names[k % 4], {'timeout': 1000})
                await claim.release()
            assert (await router.sample_fleet())['n_pools'] == 4.0
        for name in names:
            rec = router.fr_pools[name]
            await router.destroy_pool(name)
            await router.run_on(rec.shard_id, rec.aux[0].stop)
        await router.stop()
    run_async(main(), timeout=30.0)
    assert lc.violations == []
    assert lc.marshals_exercised == {'shard/worker.py'}
    assert len(lc._fsm_threads) > 4


def test_package_rel_scopes_the_ports_own_files():
    rel = t_debug._package_rel
    assert rel('/x/cueball_tpu_torch/shard/worker.py') == 'shard/worker.py'
    assert rel('/x/cueball_tpu/shard/worker.py') is None
    assert j_debug._package_rel('/x/cueball_tpu/debug.py') == 'debug.py'
    assert rel(t_debug.__file__) == 'debug.py'
    assert set(t_debug.A001_MARSHAL_MODULES) <= {
        'debug.py', 'shard/proc.py', 'shard/router.py', 'shard/worker.py',
        'wiretap.py'}


def test_init_from_env_matches_jax(caplog):
    """Both variables applied, then a bad signal name: each package logs
    the same warning and carries on."""
    prev = signal.getsignal(signal.SIGUSR1)
    try:
        t_debug.init_from_env({'CUEBALL_STACK_TRACES': '1',
                               'CUEBALL_DEBUG_SIGNAL': 'usr1'})
        assert t_utils.stack_traces_enabled()
        assert not j_utils.stack_traces_enabled()
        assert signal.getsignal(signal.SIGUSR1) is t_debug._on_debug_signal
    finally:
        t_debug.uninstall_debug_handler(prev, signal.SIGUSR1)
        t_utils.disable_stack_traces()
    messages = []
    for debug in (j_debug, t_debug):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger='cueball.debug'):
            debug.init_from_env({'CUEBALL_DEBUG_SIGNAL': 'USR9',
                                 'CUEBALL_STACK_TRACES': '0'})
        messages.append([r.getMessage() for r in caplog.records])
    assert messages[0] == messages[1] == [
        "CUEBALL_DEBUG_SIGNAL=USR9 not installed: module 'signal' has no "
        "attribute 'SIGUSR9'"]
    assert signal.getsignal(signal.SIGUSR1) == prev
    assert not t_utils.stack_traces_enabled()


def test_signal_toggles_capture_arms_the_profiler_and_dumps(alone, caplog):
    """Each SIGUSR2 toggles the port's stack capture and its claim-path
    and loop-lag samplers, and logs the dump; the second undoes the
    first."""
    prev = t_debug.install_debug_handler(signal.SIGUSR2)
    try:
        with caplog.at_level(logging.WARNING, logger='cueball.debug'):
            os.kill(os.getpid(), signal.SIGUSR2)
            on = (t_utils.stack_traces_enabled(),
                  t_profile.sampler_running())
            os.kill(os.getpid(), signal.SIGUSR2)
            off = (t_utils.stack_traces_enabled(),
                   t_profile.sampler_running())
    finally:
        t_debug.uninstall_debug_handler(prev, signal.SIGUSR2)
        t_utils.disable_stack_traces()
        t_wiretap.stop_loop_lag_sampler()
    assert (on, off) == ((True, True), (False, False))
    messages = [r.getMessage() for r in caplog.records]
    assert [m.split('\n')[0] for m in messages] == [
        'debug signal %d: stack traces now %s' % (signal.SIGUSR2, state)
        for state in ('ENABLED', 'disabled')]
    assert all('cueball FSM dump pid=%d' % os.getpid() in m
               for m in messages)
