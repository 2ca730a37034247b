"""The port's claim-path profiler (``cueball_tpu_torch.profile``) against
the JAX package's, on the CPU.

One seeded netsim scenario runs once over each package (its own
``netsim.run``, pools, tracer), with claims stamped by two shard ids:
the phase ledgers, their summary, the per-shard ``profile_record``\\ s,
their ``reduce_profile`` merge and the flamegraph are equal, and both
samplers refuse to arm under the virtual clock with one reason. Then the
port's SIGPROF sampler on the real clock: its lifecycle, its refusal off
the main thread, and the ``_prof`` seams it binds, which are the port's
own modules' and never the JAX package's.
"""

import asyncio
import threading
import types

import pytest

pytest.importorskip('torch')

from cueball_tpu import connection_fsm as j_cfsm  # noqa: E402
from cueball_tpu import fsm as j_fsm  # noqa: E402
from cueball_tpu import netsim as j_netsim  # noqa: E402
from cueball_tpu import pool as j_pool  # noqa: E402
from cueball_tpu import profile as j_profile  # noqa: E402
from cueball_tpu import resolver as j_resolver  # noqa: E402
from cueball_tpu import runq as j_runq  # noqa: E402
from cueball_tpu import trace as j_trace  # noqa: E402
from cueball_tpu_torch import connection_fsm as t_cfsm  # noqa: E402
from cueball_tpu_torch import fsm as t_fsm  # noqa: E402
from cueball_tpu_torch import netsim as t_netsim  # noqa: E402
from cueball_tpu_torch import pool as t_pool  # noqa: E402
from cueball_tpu_torch import profile as t_profile  # noqa: E402
from cueball_tpu_torch import resolver as t_resolver  # noqa: E402
from cueball_tpu_torch import runq as t_runq  # noqa: E402
from cueball_tpu_torch import trace as t_trace  # noqa: E402
from cueball_tpu_torch import utils as t_utils  # noqa: E402

JAX = types.SimpleNamespace(netsim=j_netsim, pool=j_pool, profile=j_profile,
                            resolver=j_resolver, trace=j_trace)
PORT = types.SimpleNamespace(netsim=t_netsim, pool=t_pool, profile=t_profile,
                             resolver=t_resolver, trace=t_trace)
J_SEAMS = (j_pool, j_cfsm, j_runq, j_fsm)
T_SEAMS = (t_pool, t_cfsm, t_runq, t_fsm)


@pytest.fixture(autouse=True)
def profilers_off():
    """Both packages' tracers and samplers off, their sample counts
    cleared, before and after each test."""
    def off():
        for prof, trace in ((j_profile, j_trace), (t_profile, t_trace)):
            prof.stop_sampler()
            prof.reset_samples()
            prof._disabled_reason = None
            trace.disable_tracing()
    off()
    yield
    off()


def _profiled(pkg, seed):
    """Claims over a netsim pool with tracing on, stamped shard 0, then
    shard 1, then none (the pool's ``p_shard``, as a router stamps it):
    every profiler surface over the recorded traces."""
    fabric = pkg.netsim.Fabric()

    async def run():
        pkg.trace.enable_tracing(ring_size=64, sample_rate=1.0,
                                 native=False)
        res = pkg.resolver.StaticIpResolver({'backends': [
            {'address': '10.0.0.%d' % i, 'port': 80} for i in (1, 2)]})
        pool = pkg.pool.ConnectionPool({
            'domain': 'svc.prof', 'constructor': fabric.constructor,
            'resolver': res, 'spares': 2, 'maximum': 4,
            'recovery': {'default': {'retries': 2, 'timeout': 500,
                                     'delay': 100, 'maxDelay': 400}}})
        res.start()
        while not pool.is_in_state('running'):
            await asyncio.sleep(0.05)
        armed = pkg.profile.start_sampler()
        for i in range(9):
            pool.p_shard = (0, 1, None)[i // 3]
            held = [await pool.claim({'timeout': 1000.0})
                    for _ in range(1 + i % 3)]
            await asyncio.sleep(0.005 * (i % 4 + 1))
            for hdl, _conn in held:
                hdl.release()
        await asyncio.sleep(0.1)
        prof = pkg.profile
        traces = pkg.trace.trace_ring()
        records = [prof.profile_record(shard=s) for s in (0, 1)]
        out = {'armed': armed,
               'reason': prof.sampler_stats()['disabled_reason'],
               'ledgers': prof.phase_ledger(traces),
               'summary': prof.ledger_summary(prof.phase_ledger()),
               'records': records + [prof.profile_record()],
               'merged': prof.reduce_profile(records + [None]),
               'flamegraph': prof.flamegraph(traces),
               'dump': prof.dump_profile()}
        pool.stop()
        while not pool.is_in_state('stopped'):
            await asyncio.sleep(0.05)
        res.stop()
        pkg.trace.disable_tracing()
        return out

    return pkg.netsim.run(run(), seed=seed)


@pytest.mark.parametrize('seed', [3, 1234])
def test_profile_surfaces_match_jax(seed):
    want = _profiled(JAX, seed)
    got = _profiled(PORT, seed)
    assert got == want
    assert want['armed'] is False and 'clock' in want['reason']
    assert [r['claims'] for r in want['records']] == [12, 12, 18]
    assert want['merged']['n_shards'] == 2
    assert want['flamegraph'].startswith('claim;')
    assert want['dump'].startswith('-- claim-path profiler --')


@pytest.mark.parametrize('records', [
    [],
    [{'claims': 2, 'wall_ms': 10.0, 'coverage': 1.0, 'shard': 0,
      'phase_ms': {'queue_wait': 4.0, 'lease': 6.0}},
     {'claims': 1, 'wall_ms': 10.0, 'coverage': 0.9, 'shard': 1,
      'phase_ms': {'queue_wait': 1.0, 'lease': 8.0},
      'wire_ms': {'kernel_wait': 0.5}, 'wire_claims': 1}, None],
])
def test_reduce_profile_matches_jax(records):
    assert t_profile.reduce_profile(records) == \
        j_profile.reduce_profile(records)


def test_sampler_lifecycle():
    assert not t_profile.sampler_running()
    assert t_profile.start_sampler(interval_ms=2.0) is True
    assert t_profile.start_sampler() is True          # idempotent
    stats = t_profile.sampler_stats()
    assert stats['running'] and stats['engine'] == 'pure'
    assert stats['ring']['capacity'] == t_profile.DEFAULT_SAMPLER_RING
    t0 = t_utils.wall_time()
    while t_utils.wall_time() - t0 < 0.2:             # SIGPROF is CPU time
        sum(range(500))
    assert t_profile.stop_sampler() is True
    assert t_profile.stop_sampler() is False
    stats = t_profile.sampler_stats()
    assert not stats['running'] and stats['samples'] > 0
    assert 'ring' not in stats
    text = t_profile.flamegraph()
    assert text.startswith('sampler;') and text.endswith('\n')
    assert t_profile.dump_profile().startswith(
        '-- claim-path profiler --\n  sampler: stopped samples=')
    t_profile.reset_samples()
    assert t_profile.sampler_stats()['samples'] == 0
    assert t_profile.flamegraph() == '' and t_profile.dump_profile() == ''


def test_sampler_refuses_off_the_main_thread():
    out = []
    th = threading.Thread(target=lambda: out.append((
        t_profile.start_sampler(),
        t_profile.sampler_stats()['disabled_reason'])))
    th.start()
    th.join(10)
    assert out[0][0] is False
    assert out[0][1].startswith('cannot arm SIGPROF here')
    assert not t_profile.sampler_running()


def test_sampler_binds_the_ports_seams_only():
    """With both packages loaded, the port's sampler binds the port's
    pool, connection_fsm, runq and fsm seams to itself and leaves the
    JAX package's alone; stopped, it unbinds them."""
    assert t_profile._SEAM_MODULES == tuple(
        'cueball_tpu_torch.' + m for m in ('pool', 'connection_fsm', 'runq',
                                           'fsm'))
    assert t_profile.start_sampler() is True
    try:
        assert all(mod._prof is t_profile for mod in T_SEAMS)
        assert all(mod._prof is None for mod in J_SEAMS)
        tok = t_profile.push_phase('codel')
        assert t_profile._pure_hint == t_profile._PHASE_IDS['codel']
        t_profile.pop_phase(tok)
        assert t_profile._pure_hint == t_profile._PHASE_IDS['other']
        with pytest.raises(KeyError):
            t_profile.push_phase('not-a-phase')
    finally:
        t_profile.stop_sampler()
    assert all(mod._prof is None for mod in T_SEAMS + J_SEAMS)


def test_sampler_attributes_a_pushed_phase():
    """A sample taken while a phase is pushed lands on that phase; one
    in the runq module's frames on runq_pump."""
    frame = types.SimpleNamespace(f_code=types.SimpleNamespace(
        co_filename='/x/cueball_tpu_torch/runq.py', co_name='_pump'))
    tok = t_profile.push_phase('handshake')
    t_profile._pure_sigprof(0, None)
    t_profile.pop_phase(tok)
    t_profile._pure_sigprof(0, frame)
    t_profile._collect_samples()
    assert t_profile._samples == {('handshake', 'engine'): 1,
                                  ('runq_pump', '_pump'): 1}
    assert t_profile.flamegraph() == ('sampler;runq_pump;_pump 1\n'
                                      'sampler;handshake;engine 1\n')
