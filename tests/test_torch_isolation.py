"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, nor ``torch.distributed`` (its mesh is one process over a grid
of devices), and runs its telemetry step, its live sampler (with the
control and health planes, plain and over a mesh), its fleet passes
over shard loops, its kang routes, its debug dump, its examples'
modules, its bench, its chip-capture tool, its own pool layer (a
``ConnectionPool`` over a loopback server, claimed, sampled and acted
on by the control step), its service discovery (a ``DNSResolver``
over a UDP nameserver, a ``ConnectionSet`` and a pool over it, a netsim
``Scenario`` over ``FabricTransport``, ``cbresolve`` and the kang object
routes) and its shard router (a claim routed through a 2-shard thread
router under the profiler's sampler, the FSM dump, ``/kang/shards``
and ``/kang/profile``) where neither JAX nor ``cueball_tpu`` can be
imported. The inference-fleet example's script reaches no module of the
JAX package either. No string constant of the port's sources but a
docstring names a module of the JAX package: a seam bound by name
(the profiler's ``_prof`` seams, a ``sys.modules`` lookup, a job spec)
would otherwise reach that package when both are loaded."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip('torch')

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ('jax', 'jaxlib', 'cueball_tpu', '__graft_entry__', 'bench',
             'tools')

_NO_JAX = """
import sys
for name in ('jax', 'jaxlib', 'cueball_tpu', '__graft_entry__', 'bench',
             'tools'):
    sys.modules[name] = None
import cueball_tpu_torch as ct
import cueball_tpu_torch.shard
from cueball_tpu_torch.entry import entry
fn, (state, inp) = entry(device='cpu')
state, out, fleet = fn(state, inp)
assert out['filtered'].shape == (1024,)
assert float(fleet['n_pools']) == 1024.0

from cueball_tpu_torch import host
from cueball_tpu_torch.monitor import PoolMonitor
from cueball_tpu_torch.parallel import FleetSampler


class Pool:
    p_uuid, p_spares, p_max, p_codel = 'iso-1', 2.0, 8.0, None
    p_waiters, p_connections = (), {}

    def lp_load_sample(self):
        return 3.0


mon = PoolMonitor()
mon.register_pool(Pool())
s = FleetSampler({'monitor': mon, 'device': 'cpu', 'control': True,
                  'health': True})
s.sample_once()               # starts the health monitor's sink
for sink in host.backend_sinks():
    sink.observe('iso-backend', 4.0, 5.0, True)
rec = s.sample_once()
assert rec['fleet']['n_pools'] == 1.0
assert rec['control']['epoch'] == 2
assert 'iso-backend' in rec['health']['backends']
s.stop()

from cueball_tpu_torch.parallel import Mesh
meshed = FleetSampler({'monitor': mon, 'device': 'cpu', 'control': True,
                       'health': True, 'mesh': Mesh(['cpu'] * 2, ('pools',))})
rec = meshed.sample_once()
assert rec['fleet']['n_pools'] == 1.0 and len(meshed.fs_state) == 2
assert meshed.snapshot()['mesh']['n_devices'] == 2
meshed.stop()

import asyncio
import cueball_tpu_torch.examples.fleet_mesh_sampler
import cueball_tpu_torch.examples.telemetry_replay
from cueball_tpu_torch import debug, http_server
from cueball_tpu_torch.entry import ShardedWorkload
from cueball_tpu_torch.shard.fleet import FleetRuntime

work = ShardedWorkload(2, 4)
rt = FleetRuntime(work, work.options(device='cpu'))


async def passes():
    work.advance()
    assert (await rt.sample_fleet())['n_pools'] == 8.0
    await rt.health_fleet()
    await rt.stop()
asyncio.run(passes())
work.close()
assert http_server.route('GET', '/kang/nowhere')[0] == 404

import cueball_tpu_torch.examples.inference_fleet_client
import cueball_tpu_torch.tools.chip_bench
from cueball_tpu_torch import bench
stages = []
bench.run_stages(stages.append, device='cpu', pools=64, max_iters=1)
assert [r['stage'] for r in stages] == bench.stage_names(64)
assert 'fleet runtime' in debug.dump_fleet_runtime()


async def pool_loop():
    server = await asyncio.start_server(lambda r, w: None, '127.0.0.1', 0)
    port = server.sockets[0].getsockname()[1]
    res = ct.StaticIpResolver({'backends': [{'address': '127.0.0.1',
                                             'port': port}]})
    res.start()
    pool = ct.ConnectionPool({
        'domain': 'iso.local', 'spares': 1, 'maximum': 2,
        'transport': 'asyncio', 'resolver': res, 'controlActuation': True,
        'recovery': {'default': {'timeout': 2000, 'retries': 1,
                                 'delay': 100}}})
    hdl, conn = await pool.claim({'timeout': 2000})
    hdl.release()
    sampler = ct.FleetSampler({'monitor': ct.pool_monitor, 'device': 'cpu',
                               'control': True, 'taps': 2})
    recs = [sampler.sample_once() for _ in range(3)]
    sampler.stop()
    assert recs[-1]['fleet']['n_pools'] == 1.0
    assert recs[-1]['control']['applied'] == 1
    assert pool.p_ctrl_epoch == recs[-1]['control']['epoch'] == 3
    assert pool.get_stats()['counters']['claim'] == 1
    pool.stop()
    res.stop()
    server.close()
asyncio.run(pool_loop())

from cueball_tpu_torch import cli, dns_resolver, netsim, transport
from cueball_tpu_torch.examples import discovered_fleet, multiplexed_set_client
dns_resolver.have_global_v6 = lambda: False


async def discovery():
    zone = discovered_fleet.fleet_zone(1, [9000 + j for j in range(9)])
    udp, ns, port = await discovered_fleet.serve_zone(zone)
    res = ct.DNSResolver({'domain': discovered_fleet.service_name(0),
                          'service': '_http._tcp',
                          'resolvers': ['127.0.0.1@%d' % port],
                          'recovery': {'default': {'timeout': 1000,
                                                   'retries': 1,
                                                   'delay': 10}}})
    res.start()
    while not res.is_in_state('running'):
        await asyncio.sleep(0.005)
    assert res.count() == 8
    cset = ct.ConnectionSet({'constructor': lambda b: ct.EventEmitter(),
                             'resolver': res, 'target': 1, 'maximum': 2,
                             'recovery': {'default': {'timeout': 100,
                                                      'retries': 0,
                                                      'delay': 0}}})
    assert cset.is_in_state('starting') or cset.is_in_state('running')
    cset.stop()
    res.stop()
    udp.close()
    assert ns.answered['SRV'] == 1
asyncio.run(discovery())
import contextlib
import io
listed = io.StringIO()
with contextlib.redirect_stdout(listed):
    assert cli.main(['-S', '127.0.0.1:8080']) == 0
assert listed.getvalue().split()[:2] == ['127.0.0.1', '8080']

fabric = netsim.Fabric()
sc = netsim.Scenario('isolation', seed=1)


async def simulated():
    res = ct.StaticIpResolver({'backends': [{'address': '10.0.0.1',
                                             'port': 80}]})
    res.start()
    pool = ct.ConnectionPool({'domain': 'sim', 'resolver': res,
                              'transport': transport.FabricTransport(fabric),
                              'spares': 1, 'maximum': 1,
                              'recovery': {'default': {'timeout': 500,
                                                       'retries': 1,
                                                       'delay': 10}}})
    out = await netsim.herd(pool, 5, timeout_ms=500)
    pool.stop()
    res.stop()
    return out
assert all(r['ok'] for r in sc.run(simulated))
assert sc.trace
for path in ('/kang/types', '/kang/snapshot', '/kang/traces',
             '/kang/transport'):
    assert http_server.route('GET', path)[0] == 200, path


async def routed():
    router = ct.shard.FleetRouter({'shards': 2, 'backend': 'thread',
                                   'device': 'cpu'})
    await router.start()
    server = await asyncio.start_server(lambda r, w: None, '127.0.0.1', 0)
    port = server.sockets[0].getsockname()[1]

    def build():
        res = ct.StaticIpResolver({'backends': [{'address': '127.0.0.1',
                                                 'port': port}]})
        res.start()
        return ct.ConnectionPool({
            'domain': 'iso.routed', 'spares': 1, 'maximum': 1,
            'transport': 'asyncio', 'resolver': res,
            'recovery': {'default': {'timeout': 2000, 'retries': 1,
                                     'delay': 100}}}), res
    rec = await router.create_pool('iso.routed', factory=build)
    assert profile.start_sampler()
    claim = await router.claim('iso.routed', {'timeout': 2000})
    await claim.release()
    assert profile.stop_sampler()
    dump = ct.dump_fsm_histories()
    assert 'fleet_router backend=thread shards=2' in dump
    assert '  pool iso.routed' in dump
    assert http_server.route('GET', '/kang/shards')[0] == 200
    await router.run_on(rec.shard_id, rec.pool.stop)
    await router.run_on(rec.shard_id, rec.aux[0].stop)
    await router.stop()
    server.close()
from cueball_tpu_torch import profile
asyncio.run(routed())
for path in ('/kang/profile', '/kang/profile?phase=lease'):
    assert http_server.route('GET', path)[0] == 200, path
assert not [m for m, mod in sys.modules.items() if mod is not None and
            m.split('.')[0] in ('jax', 'jaxlib', 'cueball_tpu', 'bench',
                                'tools')]
print('ok')
"""


def _imported_names(node) -> list:
    """Module names an import statement reads, with `from a import b`
    as both `a` and `a.b`."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0:
        base = node.module or ''
        return [base] + ['%s.%s' % (base, a.name) for a in node.names]
    return []


def _forbidden_imports(path: Path) -> list:
    tree = ast.parse(path.read_text(encoding='utf-8'), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        for name in _imported_names(node):
            if name.split('.')[0] in FORBIDDEN or \
                    name.startswith('torch.distributed'):
                bad.append('%s:%d %s' % (path.name, node.lineno, name))
    return bad


def test_port_runs_with_jax_unimportable():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, '-c', _NO_JAX], cwd=str(ROOT),
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == 'ok'


def test_port_sources_import_no_jax():
    files = sorted((ROOT / 'cueball_tpu_torch').rglob('*.py'))
    files += sorted((ROOT / 'examples_torch').rglob('*.py'))
    files.append(ROOT / 'chip_smoke.py')
    names = {str(f.relative_to(ROOT)) for f in files}
    for module in ('_cast', 'codel', 'debug', 'errors', 'events', 'host',
                   'http_server', 'monitor', 'parallel/control',
                   'parallel/health', 'parallel/mesh', 'parallel/sampler',
                   'shard/__init__', 'shard/fleet', 'shard/ring',
                   'shard/worker', 'shard/proc', 'shard/router',
                   'examples/__init__', 'examples/sharded_fleet',
                   'examples/telemetry_replay',
                   'examples/fleet_mesh_sampler',
                   'examples/inference_fleet_client', 'bench',
                   'tools/__init__', 'tools/chip_bench', 'metrics',
                   'utils', 'runq', 'fsm', 'cqueue', 'wiretap', 'trace',
                   'profile', 'connection_fsm', 'pool', 'resolver',
                   'transport', 'agent', 'dns_client', 'dns_resolver',
                   'cset', 'cli', 'netsim/__init__', 'netsim/clock',
                   'netsim/dns', 'netsim/fabric', 'netsim/scenario',
                   'examples/multiplexed_set_client',
                   'examples/discovered_fleet', 'examples/pool_fleet'):
        assert 'cueball_tpu_torch/%s.py' % module in names
    assert 'examples_torch/inference_fleet_client.py' in names
    bad = [b for f in files for b in _forbidden_imports(f)]
    assert bad == []


def _docstrings(tree) -> set:
    """ids of the string constants that are docstrings."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and \
                    isinstance(first.value, ast.Constant):
                out.add(id(first.value))
    return out


def _jax_module_strings(path: Path) -> list:
    """String constants of ``path``, docstrings aside, that name a
    module of the JAX package (``cueball_tpu.`` followed by a name)."""
    tree = ast.parse(path.read_text(encoding='utf-8'), filename=str(path))
    docs = _docstrings(tree)
    return ['%s:%d %r' % (path.name, node.lineno, node.value)
            for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs
            and re.search(r'\bcueball_tpu\.[A-Za-z_]', node.value)]


def test_port_strings_name_no_jax_module():
    files = sorted((ROOT / 'cueball_tpu_torch').rglob('*.py'))
    files += sorted((ROOT / 'examples_torch').rglob('*.py'))
    files.append(ROOT / 'chip_smoke.py')
    assert [b for f in files for b in _jax_module_strings(f)] == []
    # The scan sees what it is for: a seam named in a string constant.
    probe = ROOT / 'cueball_tpu' / 'profile.py'
    assert any("'cueball_tpu.pool'" in b for b in _jax_module_strings(probe))


def test_example_script_reaches_only_the_pool_layer():
    """``examples_torch/inference_fleet_client.py`` runs the example on
    the port's own pool layer: it imports no module of ``cueball_tpu``
    (nor JAX), and runs with both unimportable."""
    script = ROOT / 'examples_torch' / 'inference_fleet_client.py'
    tree = ast.parse(script.read_text(encoding='utf-8'))
    names = [n for node in ast.walk(tree) for n in _imported_names(node)]
    assert 'cueball_tpu_torch.examples' in names
    assert not [n for n in names
                if n.split('.')[0] in ('jax', 'jaxlib', 'cueball_tpu')]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    code = ("import runpy, sys\n"
            "for name in ('jax', 'jaxlib', 'cueball_tpu'):\n"
            "    sys.modules[name] = None\n"
            "sys.argv = ['inference_fleet_client.py', '--requests', '4',\n"
            "            '--device', 'cpu']\n"
            "try:\n"
            "    runpy.run_path(%r, run_name='__main__')\n"
            "finally:\n"
            "    assert not [m for m, mod in sys.modules.items()\n"
            "                if mod is not None and m.split('.')[0] in\n"
            "                ('jax', 'jaxlib', 'cueball_tpu')]\n"
            % str(script))
    r = subprocess.run([sys.executable, '-c', code], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines()[0] == 'done: 4 ok, 0 failed'
