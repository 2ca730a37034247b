"""The port's two examples against the JAX package's, on the CPU.

Each example runs as a user runs it, with ``python -m`` on the CPU, and
its findings lines must be the JAX example's on the same seeded inputs.
Then the results themselves are held row by row: the replay's [T, P]
outputs and [T] aggregates against the JAX ``fleet_scan`` over the JAX
example's window, and the mesh demo's per-tick ``filtered`` and
``drop`` against the JAX example's mesh sampler over the same 12-pool
fleet, seed and clock instants. Floats to rtol 1e-5 / atol 1e-5;
drops exactly; ``target`` and ``clamped`` exactly off their rounding
boundary (``convert.target_near_boundary``)."""

import asyncio
import importlib.util
import json
import os
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip('torch')

from cueball_tpu_torch import convert  # noqa: E402
from cueball_tpu_torch.examples import (  # noqa: E402
    fleet_mesh_sampler, inference_fleet_client, telemetry_replay)

ROOT = Path(__file__).resolve().parent.parent
RTOL = ATOL = 1e-5


def run_example(name: str) -> list:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run(
        [sys.executable, '-m', 'cueball_tpu_torch.examples.' + name,
         '--device', 'cpu'], cwd=str(ROOT), env=env, capture_output=True,
        text=True, timeout=20)
    assert r.returncode == 0, r.stderr
    return r.stdout.splitlines()


def load_jax_example(name: str):
    """A fresh copy of ``examples/<name>.py`` of the JAX package."""
    pytest.importorskip('jax')
    spec = importlib.util.spec_from_file_location(
        'jax_example_' + name, ROOT / 'examples' / (name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_telemetry_replay_finds_the_overload_peak(capsys):
    lines = run_example('telemetry_replay')
    assert lines[0] == ('replayed 200 ticks x 64 pools with one fleet_scan '
                        'call (200 steps on cpu)')
    jax_example = load_jax_example('telemetry_replay')
    capsys.readouterr()
    jax_example.main()
    want = capsys.readouterr().out.splitlines()
    assert want[0] == 'replayed 200 ticks x 64 pools in one compiled scan'
    # Mean load, the peak's value and tick, the drops and the clamps.
    assert lines[1:] == want[1:]
    assert 'overload fraction peaked at 0.50 (tick 83)' in lines


def test_telemetry_replay_matches_jax_scan_row_by_row():
    jax_example = load_jax_example('telemetry_replay')
    _, j_outs, j_fleets = jax_example.fleet_scan(
        jax_example.fleet_init(jax_example.P), jax_example.synth_window())
    got = telemetry_replay.main(device='cpu')
    assert got['samples'].shape == (telemetry_replay.T, telemetry_replay.P)

    edge = convert.target_near_boundary(
        np.asarray(j_outs['filtered']), got['samples'], got['spares'])
    assert set(got['outs']) == set(j_outs)
    for name, want in j_outs.items():
        want = np.asarray(want)
        have = got['outs'][name]
        assert have.shape == want.shape, name
        if name in ('target', 'clamped'):
            np.testing.assert_array_equal(have[~edge], want[~edge],
                                          err_msg=name)
        elif want.dtype.kind in 'biu':
            np.testing.assert_array_equal(have, want, err_msg=name)
        else:
            np.testing.assert_allclose(have, want, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
    assert int(edge.sum()) < edge.size // 100
    assert set(got['fleets']) == set(j_fleets)
    for name, want in j_fleets.items():
        np.testing.assert_allclose(got['fleets'][name], np.asarray(want),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    assert got['drops'] == int(np.asarray(j_outs['drop']).sum()) > 0


def test_fleet_mesh_sampler_agrees_on_every_tick():
    lines = run_example('fleet_mesh_sampler')
    assert lines[0] == ("12 pools sharded over 8 devices ({'pools': 8} mesh "
                        "on cpu)")
    assert '40/40 ticks agree with the single-device sampler' in lines
    assert lines[-1] == 'mesh sampler demo ok'


def test_fleet_mesh_sampler_matches_jax_example(capsys):
    """The JAX example's own ``main`` on the tests' eight virtual
    devices, with its clock frozen and moved 200 ms a tick as the port's
    demo moves it, and its samplers recording each tick."""
    from cueball_tpu import utils as mod_utils

    jax_example = load_jax_example('fleet_mesh_sampler')
    clock = [1.0e6]
    records = {'mesh': [], 'plain': []}

    class Recording(jax_example.FleetSampler):
        def __init__(self, options):
            super().__init__(options)
            self.kind = 'mesh' if 'mesh' in options else 'plain'
            if self.kind == 'plain':
                clock[0] += 200.0      # the first tick's instant

        def sample_once(self):
            rec = super().sample_once()
            records[self.kind].append(rec)
            if self.kind == 'plain':
                clock[0] += 200.0      # the next tick's instant
            return rec

    saved = mod_utils.current_millis
    mod_utils.current_millis = jax_example.current_millis = lambda: clock[0]
    jax_example.FleetSampler = Recording
    try:
        capsys.readouterr()
        jax_example.main()
        want_lines = capsys.readouterr().out.splitlines()
    finally:
        mod_utils.current_millis = saved

    got = fleet_mesh_sampler.main(device='cpu')
    lines = capsys.readouterr().out.splitlines()
    # The same findings but for the port's added drop count.
    assert [ln for ln in lines if not ln.startswith('codel dropped')][1:] \
        == want_lines[1:]

    ticks = fleet_mesh_sampler.TICKS
    assert len(records['mesh']) == len(records['plain']) == ticks
    names = sorted(records['mesh'][0]['pools'])
    assert len(names) == 12
    want_filtered = np.array([[r['pools'][u]['filtered'] for u in names]
                              for r in records['mesh']], np.float32)
    want_drop = np.array([[r['pools'][u]['drop'] for u in names]
                          for r in records['mesh']], bool)
    np.testing.assert_array_equal(got['drop'], want_drop)
    np.testing.assert_allclose(got['filtered'], want_filtered,
                               rtol=RTOL, atol=ATOL)
    assert got['drops'] == int(want_drop.sum()) > 0


def _pool_layer():
    """The JAX package's pool layer."""
    from cueball_tpu import (agent, monitor, pool, resolver, trace, utils,
                             wiretap)
    return inference_fleet_client.pool_layer(agent, resolver, monitor, utils,
                                             pool, trace, wiretap)


def test_inference_fleet_client_matches_jax_sampler(monkeypatch, capsys):
    """Real pools over two in-process HTTP servers, sampled by the port's
    FleetSampler on the CPU and, at the same instants, by the JAX
    example's sampler: the ``FleetSampler({})`` that its
    ``start_fleet_sampler`` builds, ticked by the port's example
    instead of by its own timer. The clock is frozen and moved 200 ms
    after each tick; the fleet aggregates agree tick for tick."""
    pytest.importorskip('jax')
    from cueball_tpu import utils as mod_utils
    from cueball_tpu.parallel import FleetSampler as JaxFleetSampler

    clock = [1.0e6]
    monkeypatch.setattr(mod_utils, 'current_millis', lambda: clock[0])

    class Advancing:
        def __init__(self, sampler):
            self.sampler = sampler

        def sample_once(self):
            rec = self.sampler.sample_once()
            clock[0] += 200.0          # the next tick's instant
            return rec

        def stop(self):
            self.sampler.stop()

    async def go():
        twin = Advancing(JaxFleetSampler({}))
        return await inference_fleet_client.run(
            _pool_layer(), requests=24, device='cpu', twins=[twin])

    got = asyncio.run(go())
    out = capsys.readouterr().out
    assert 'done: 24 ok, 0 failed' in out
    assert "'mean_load'" in out
    assert got['ok'] == 24 and got['failed'] == 0
    assert got['ticks'] == 3 and got['agree'] == [3]
    assert got['fir_launches'] == 0
    assert set(got['per_backend']) == {b'srv-a', b'srv-b'}
    (want,) = got['twins']
    for mine, theirs in zip(got['fleets'], want):
        assert mine['n_pools'] >= 1
        for name, value in mine.items():
            np.testing.assert_allclose(value, theirs[name], rtol=RTOL,
                                       atol=0, err_msg=name)
    assert got['fleets'][-1]['mean_filtered'] > got['fleets'][0][
        'mean_filtered'] > 0


def test_inference_fleet_client_same_on_either_pool_layer(monkeypatch):
    """The example on the port's own pool layer and on the JAX
    package's, on the same 24 requests, each layer's clock frozen at
    the same instant and moved 200 ms after each tick (by a CPU twin
    sampler that ticks at the tick's instant): both serve every request
    and their per-tick fleet aggregates agree to rtol/atol 1e-5."""
    from random import Random

    from cueball_tpu import (agent, monitor, pool, resolver, trace, utils,
                             wiretap)
    from cueball_tpu_torch import utils as t_utils
    from cueball_tpu_torch.parallel import FleetSampler

    class Frozen:
        def __init__(self):
            self.ms = 1.0e6

        def monotonic(self):
            return self.ms / 1000.0

        def wall(self):
            return 1.7e9 + self.ms / 1000.0

    class Advancing:
        def __init__(self, layer, clock):
            self.sampler = FleetSampler({'monitor': layer.pool_monitor,
                                         'host': layer.host,
                                         'device': 'cpu'})
            self.clock = clock

        def sample_once(self):
            rec = self.sampler.sample_once()
            self.clock.ms += 200.0
            return rec

        def stop(self):
            self.sampler.stop()

    def run_on(layer, utils_mod):
        # The layer's process-wide monitor holds only this run's pool:
        # an earlier test may have left pools registered there.
        monkeypatch.setattr(layer.pool_monitor, 'pm_pools', {})
        clock = Frozen()
        old = utils_mod.set_clock(clock), utils_mod.set_rng(Random(5))
        try:
            return asyncio.run(inference_fleet_client.run(
                layer, requests=24, device='cpu',
                twins=[Advancing(layer, clock)]))
        finally:
            utils_mod.set_clock(old[0])
            utils_mod.set_rng(old[1])

    mine = run_on(inference_fleet_client.pool_layer(), t_utils)
    theirs = run_on(inference_fleet_client.pool_layer(
        agent, resolver, monitor, utils, pool, trace, wiretap), utils)
    for got in (mine, theirs):
        assert got['ok'] == 24 and got['failed'] == 0
        assert got['ticks'] == 3 and got['agree'] == [3]
    for a, b in zip(mine['fleets'], theirs['fleets']):
        assert set(a) == set(b) and a['n_pools'] >= 1
        for name in a:
            np.testing.assert_allclose(a[name], b[name], rtol=RTOL,
                                       atol=ATOL, err_msg=name)
    assert mine['fleets'][-1]['mean_filtered'] > 0


def test_pool_fleet_on_cpu_matches_its_twin(monkeypatch):
    """The pool-fleet example small on the CPU: every claim served over
    the port's own pools, every tick's fleet aggregates equal to the
    twin's over the shadows, and the sampler's advisories and decisions
    (its epoch) found on the pools, none of the twin's."""
    from cueball_tpu_torch import pool_monitor
    from cueball_tpu_torch.examples import pool_fleet
    monkeypatch.setattr(pool_monitor, 'pm_pools', {})
    res = asyncio.run(pool_fleet.run('cpu', 'cpu', pools=8, servers=4,
                                     claims=200, concurrency=8,
                                     tick_every=10, taps=4))
    assert res['served'] == 200 and res['failed'] == []
    assert res['ticks'] == 22 == len(res['twin_records'])
    assert res['fir_launches'] == 0
    for got, want in zip(res['records'], res['twin_records']):
        assert got['fleet'] == want['fleet']
        assert got['fleet']['n_pools'] == 8
        assert got['control']['epoch'] == want['control']['epoch']
        assert want['control']['applied'] == 0
    reached = res['reached']
    assert reached['epoch'] == 22
    assert reached['applied'] > 0 and reached['decisions'] > 0
    assert reached['advisories'] > 0


def test_inference_fleet_client_script_with_cpu_twin(monkeypatch, capsys):
    """The example's script as a user runs it, in-process, on the CPU,
    with a twin sampler on the CPU."""
    monkeypatch.setattr(sys, 'argv', [
        'inference_fleet_client.py', '--requests', '12', '--device', 'cpu',
        '--twin-device', 'cpu'])
    with pytest.raises(SystemExit) as done:
        runpy.run_path(str(ROOT / 'examples_torch' /
                           'inference_fleet_client.py'), run_name='__main__')
    assert done.value.code == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == 'done: 12 ok, 0 failed'
    assert 'fleet aggregates agree with cpu on 2/2 ticks' in lines[-2]
    summary = json.loads(lines[-1])
    assert summary['ok'] == 12 and summary['agree'] == [2]
    assert summary['fleet']['n_pools'] >= 1


def test_discovered_fleet_on_cpu_matches_its_twin(monkeypatch):
    """The discovered-fleet example small on the CPU: 200 claims over
    16 pools whose backends come from DNS over a UDP nameserver, the
    SRV sets changed at claim 100. Every claim and agent request is
    served, every tick's fleet aggregates equal the twin's, and the
    swap is seen by every pool, its connections, its monitor record,
    the servers and the health table."""
    from cueball_tpu_torch import pool_monitor
    from cueball_tpu_torch.examples import discovered_fleet
    monkeypatch.setattr(pool_monitor, 'pm_pools', {})
    res = asyncio.run(discovered_fleet.run(
        'cpu', 'cpu', services=16, claims=200, swap_at=100, concurrency=8,
        tick_every=10, taps=4, agent_requests=10))
    assert res['served'] == 200 and res['failed'] == []
    assert res['agent'] == {'ok': 10, 'failed': 0}
    assert res['ticks'] == 22 == len(res['twin_records'])
    assert res['fir_launches'] == 0
    for got, want in zip(res['records'], res['twin_records']):
        assert got['fleet'] == want['fleet']
        assert got['fleet']['n_pools'] == 16
        assert want['control']['applied'] == 0
    swap = res['swap']
    assert swap['pools_removed_b0'] == swap['pools_added_b8'] == 16
    assert swap['pools_on_server0'] == 0
    assert swap['pools_listing_new_set'] == 16
    assert swap['b8_row'] < swap['health_rows'] and swap['b8_in_health']
    assert res['by_server'].get(discovered_fleet.TARGETS, 0) > 0
    assert res['answered_before_swap']['SRV'] == 16
    assert res['answered']['SRV'] >= 32
    assert res['reached']['applied'] > 0


def _masked(text: str) -> list:
    """Output lines with every number and backend key masked."""
    import re
    out = []
    for line in text.splitlines():
        line = re.sub(r'(\[set\] (?:added|removed)\s+)\S{12}', r'\1<key>',
                      line)
        out.append(re.sub(r'\d+', '<n>', line))
    return sorted(out)


def test_multiplexed_set_client_matches_jax(capsys):
    """The port's multiplexed-set example prints what the JAX example
    prints, numbers and keys masked: three servers advertised, 60 calls
    spread, one server killed, 30 calls served by the other two, a
    clean shutdown."""
    from cueball_tpu_torch.examples import multiplexed_set_client
    jax_example = load_jax_example('multiplexed_set_client')
    asyncio.run(jax_example.main())
    want = capsys.readouterr().out
    asyncio.run(multiplexed_set_client.main())
    got = capsys.readouterr().out
    assert _masked(got) == _masked(want)
    assert '30/30 calls served by the surviving backends' in got
    assert got.count('[set] added') >= 3


def test_inference_fleet_client_dns_mode_matches_jax(monkeypatch, capsys):
    """``--domain`` mode on the port's pool layer and the JAX example's
    ``run_dns`` on its own, against one nameserver on 127.0.0.1 whose
    SRV records name two HTTP servers: every request served by both;
    the port's command line too (``--resolvers``)."""
    from cueball_tpu import dns_resolver as j_dns
    from cueball_tpu_torch import dns_resolver as t_dns
    from cueball_tpu_torch.examples import discovered_fleet
    from cueball_tpu_torch.netsim import SimZone
    jax_example = load_jax_example('inference_fleet_client')
    domain, service = 'infer.fleet.test', '_http._tcp'
    for mod in (j_dns, t_dns):
        monkeypatch.setattr(mod, 'have_global_v6', lambda: False)

    async def go():
        servers, addrs = await inference_fleet_client._serve_fleet()
        zone = SimZone()
        for i, addr in enumerate(addrs):
            zone.add_srv_backend('%s.%s' % (service, domain),
                                 'b%d.%s' % (i, domain),
                                 int(addr.partition(':')[2]), '127.0.0.1')
        transport, ns, port = await discovered_fleet.serve_zone(zone)
        nameserver = '127.0.0.1@%d' % port
        # The JAX example reads its nameservers from the host's
        # resolv.conf: point that at the nameserver.
        monkeypatch.setattr(j_dns, '_read_resolv_conf',
                            lambda path=None: [nameserver])
        try:
            await jax_example.run_dns(domain, service, 12)
            want = capsys.readouterr().out
            res = await inference_fleet_client.run_dns(
                inference_fleet_client.pool_layer(), domain, service, 12,
                resolvers=[nameserver])
            got = capsys.readouterr().out
            rc = await asyncio.to_thread(inference_fleet_client.main, None, [
                '--domain', domain, '--service', service, '--requests', '5',
                '--resolvers', nameserver])
            cli = capsys.readouterr().out
        finally:
            transport.close()
            for s in servers:
                s.close()
        return want, got, res, rc, cli, dict(ns.answered)

    want, got, res, rc, cli, answered = asyncio.run(go())
    assert got == want == 'done: 12 ok, 0 failed\n'
    assert res == {'ok': 12, 'failed': 0}
    assert rc == 0 and json.loads(cli.splitlines()[-1]) == {'ok': 5,
                                                            'failed': 0}
    assert answered['SRV'] >= 3
