"""The port's ``cbresolve`` (``cueball_tpu_torch.cli``) and its kang
object routes (``cueball_tpu_torch.http_server``) against the JAX
package's.

``cbresolve`` runs in static mode, in DNS mode against a UDP nameserver
on 127.0.0.1 (the port's ``SimZone`` served by
``examples.discovered_fleet.Nameserver``), in follow mode through a
change of the SRV set, and on bad input, once with each package's CLI
on that package's virtual-time loop; the exit codes, standard output
and standard error must be equal once the follow mode's timestamps are
masked. The kang routes answer from each package's own pool monitor,
tracer and wire ledger over the same seeded fleet (a pool, a set and a
DNS resolver); the JSON must be equal, but for the ``component`` that
names the serving package.
"""

import asyncio
import contextlib
import io
import json
import re
import types

import pytest

pytest.importorskip('torch')

from cueball_tpu import cli as j_cli  # noqa: E402
from cueball_tpu import cset as j_cset  # noqa: E402
from cueball_tpu import dns_resolver as j_dns  # noqa: E402
from cueball_tpu import http_server as j_http  # noqa: E402
from cueball_tpu import metrics as j_metrics  # noqa: E402
from cueball_tpu import netsim as j_netsim  # noqa: E402
from cueball_tpu import pool as j_pool  # noqa: E402
from cueball_tpu import profile as j_profile  # noqa: E402
from cueball_tpu import resolver as j_resolver  # noqa: E402
from cueball_tpu import trace as j_trace  # noqa: E402
from cueball_tpu import transport as j_transport  # noqa: E402
from cueball_tpu import wiretap as j_wiretap  # noqa: E402
from cueball_tpu_torch import cli as t_cli  # noqa: E402
from cueball_tpu_torch import cset as t_cset  # noqa: E402
from cueball_tpu_torch import dns_resolver as t_dns  # noqa: E402
from cueball_tpu_torch import http_server as t_http  # noqa: E402
from cueball_tpu_torch import metrics as t_metrics  # noqa: E402
from cueball_tpu_torch import netsim as t_netsim  # noqa: E402
from cueball_tpu_torch import pool as t_pool  # noqa: E402
from cueball_tpu_torch import profile as t_profile  # noqa: E402
from cueball_tpu_torch import resolver as t_resolver  # noqa: E402
from cueball_tpu_torch import trace as t_trace  # noqa: E402
from cueball_tpu_torch import transport as t_transport  # noqa: E402
from cueball_tpu_torch import wiretap as t_wiretap  # noqa: E402
from cueball_tpu_torch.examples import discovered_fleet  # noqa: E402

JAX = types.SimpleNamespace(
    cli=j_cli, cset=j_cset, dns=j_dns, metrics=j_metrics, netsim=j_netsim,
    pool=j_pool, resolver=j_resolver, trace=j_trace, transport=j_transport,
    wiretap=j_wiretap, route=lambda path, c: j_http._route('GET', path, c))
PORT = types.SimpleNamespace(
    cli=t_cli, cset=t_cset, dns=t_dns, metrics=t_metrics, netsim=t_netsim,
    pool=t_pool, resolver=t_resolver, trace=t_trace, transport=t_transport,
    wiretap=t_wiretap,
    route=lambda path, c: t_http.route('GET', path, collector=c))
PORTS = [8000 + j for j in range(discovered_fleet.SERVERS)]
STAMP = re.compile(r'^\d{4}-\d\d-\d\dT[0-9:.+]+ ')
SEED = 3


@pytest.fixture(autouse=True)
def isolated():
    """Each test starts with both packages' claim tracers and wire
    ledgers off (one left on by another test would draw from the seeded
    RNG and count into the records) and with empty class-wide registries
    of DNS bootstrap resolvers and nameserver clients, which are put
    back after it: a bootstrap resolver left registered under a name
    would be reused by the next resolver that names it."""
    for trace, wiretap in ((j_trace, j_wiretap), (t_trace, t_wiretap)):
        trace.disable_tracing()
        wiretap.disable_wiretap()
    saved = [(fsm, fsm.bootstrap_resolvers, fsm.global_ns_clients)
             for fsm in (j_dns.DNSResolverFSM, t_dns.DNSResolverFSM)]
    for fsm, _boot, _clients in saved:
        fsm.bootstrap_resolvers, fsm.global_ns_clients = {}, {}
    yield
    for fsm, boot, clients in saved:
        fsm.bootstrap_resolvers, fsm.global_ns_clients = boot, clients


def cbresolve(pkg, argv, change_at=None, follow_s=None):
    """``cbresolve argv`` over ``pkg`` on its virtual loop, with a
    nameserver for the fleet zone of ``discovered_fleet`` on the same
    loop (``NS`` in ``argv`` is its address). With ``follow_s`` the
    follow mode runs that many virtual seconds, the SRV set of
    ``svc00`` changing at ``change_at``. Returns (exit code, stdout,
    stderr), timestamps masked."""
    zone = discovered_fleet.fleet_zone(1, PORTS)

    async def main():
        transport, _ns, port = await discovered_fleet.serve_zone(zone)
        args = pkg.cli._build_parser().parse_args(
            [a.replace('NS', '127.0.0.1@%d' % port) for a in argv])
        task = asyncio.ensure_future(pkg.cli._amain(args))
        try:
            if follow_s is not None:
                await asyncio.sleep(change_at)
                discovered_fleet.set_targets(
                    zone, 0, PORTS, range(1, discovered_fleet.TARGETS + 1))
                await asyncio.sleep(follow_s - change_at)
                task.cancel()
            return await task
        finally:
            transport.close()

    out, err = io.StringIO(), io.StringIO()
    saved = pkg.dns.have_global_v6
    pkg.dns.have_global_v6 = lambda: False
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err), set_aside(pkg):
            rc = pkg.netsim.run(main(), seed=SEED)
    finally:
        pkg.dns.have_global_v6 = saved
    lines = [STAMP.sub('<time> ', ln) for ln in out.getvalue().splitlines()]
    return rc, lines, err.getvalue()


DNS_ARGV = ['-r', 'NS', '-s', discovered_fleet.SERVICE,
            discovered_fleet.service_name(0)]


@pytest.mark.parametrize('argv', [
    ['-S', '127.0.0.1:8080', '10.0.0.5'],
    ['-S', '-p', '9000', '10.0.0.5', '10.0.0.6:81'],
    ['-S', '-p', '70000', '1.2.3.4'],
    ['a.example.com', 'b.example.com'],
    ['127.0.0.2:9090'],
    DNS_ARGV,
    ['-p', '81', '-t', '2s'] + DNS_ARGV,
    ['-r', 'NS', '-s', '_nope._tcp', '-t', '300', 'nowhere.fleet.test'],
], ids=['static', 'static-port', 'bad-port', 'two-names', 'ip-input',
        'dns', 'dns-port-timeout', 'dns-failure'])
def test_cbresolve_matches_jax(argv):
    want = cbresolve(JAX, argv)
    got = cbresolve(PORT, argv)
    assert got == want
    if argv is DNS_ARGV:
        assert want[0] == 0 and sorted(want[1]) == sorted(
            '%-16s %5d %s' % ('127.0.0.1', PORTS[j],
                              discovered_fleet.backend_key(j, PORTS))
            for j in range(discovered_fleet.TARGETS))


def test_cbresolve_follow_mode_matches_jax():
    """Follow mode through a change of the SRV set: the same added and
    removed lines, in the same order."""
    argv = ['-f'] + DNS_ARGV
    want = cbresolve(JAX, argv, change_at=0.5, follow_s=3.0)
    got = cbresolve(PORT, argv, change_at=0.5, follow_s=3.0)
    assert got == want
    rc, lines, _err = want
    assert rc == 0
    assert sum(' added ' in ln for ln in lines) == \
        discovered_fleet.TARGETS + 1
    assert sum(' removed ' in ln for ln in lines) == 1


def test_cbresolve_static_rejects_domain_as_jax():
    msgs = []
    for cli in (j_cli, t_cli):
        with pytest.raises(SystemExit) as err:
            cli.main(['-S', 'foo.example.com'])
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and 'not an IP' in msgs[0]
    for bad in ('0', '5h', '1.5s', '05'):
        with pytest.raises(Exception) as j_err:
            j_cli.parse_time_interval(bad)
        with pytest.raises(Exception) as t_err:
            t_cli.parse_time_interval(bad)
        assert str(t_err.value) == str(j_err.value)
    assert [t_cli.parse_time_interval(s) for s in ('500', '250ms', '30s',
                                                   '5m')] == \
        [j_cli.parse_time_interval(s) for s in ('500', '250ms', '30s',
                                                '5m')]


# -- the kang object routes -------------------------------------------------

PATHS = ['/kang/types', '/kang/objects/pool', '/kang/objects/set',
         '/kang/objects/dns_res', '/kang/objects/nope', '/kang/snapshot',
         '/kang/obj/pool/{pool}', '/kang/obj/set/{set}',
         '/kang/obj/dns_res/{dns}', '/kang/obj/pool/missing',
         '/kang/traces', '/kang/traces?limit=2', '/kang/traces?limit=x',
         '/kang/traces?limit=-1', '/kang/traces?backend=nobody',
         '/kang/transport', '/kang/transport?transport=fabric',
         '/kang/transport?seam=connector', '/kang/transport?seam=bogus',
         '/kang/transport?transport=nope', '/kang/transport?x=1',
         '/metrics', '/kang/nowhere']


def _kang_record(pkg):
    """Every path of ``PATHS`` answered by ``pkg``'s routes over a
    seeded fleet of its own, tracing and the wire ledger on."""
    ns = pkg.netsim
    fabric = ns.Fabric()
    zone = ns.SimZone()
    zone.add_srv_backend('_http._tcp.svc.sim', 'b1.sim', 80, '10.0.0.1',
                         ttl=60, addr_ttl=60)
    transport = pkg.transport.FabricTransport(fabric, ns.SimWire(zone))
    recovery = {'default': {'timeout': 500, 'retries': 1, 'delay': 50}}

    async def main():
        res = pkg.resolver.StaticIpResolver({'backends': [
            {'address': '10.0.0.%d' % i, 'port': 80} for i in (1, 2)]})
        res.start()
        pool = pkg.pool.ConnectionPool({
            'domain': 'svc.sim', 'transport': transport, 'resolver': res,
            'spares': 1, 'maximum': 2, 'recovery': recovery})
        cset = pkg.cset.ConnectionSet({
            'constructor': fabric.constructor, 'resolver': res,
            'target': 1, 'maximum': 2, 'recovery': recovery})
        cset.on('added', lambda k, c, h: None)
        cset.on('removed', lambda k, c, h: h.release())
        def answer(q):
            rcode, answers, authority = zone.resolve(q['domain'], q['type'])
            return ns.DnsOutcome(answers=answers, authority=authority,
                                 rcode=rcode)
        dns = pkg.dns.DNSResolver({
            'domain': 'svc.sim', 'service': '_http._tcp',
            'resolvers': ['10.0.0.53'], 'recovery': recovery,
            'dnsClient': ns.ScriptedDnsClient(answer)})
        dns.start()
        while not (pool.is_in_state('running') and
                   dns.is_in_state('running')):
            await asyncio.sleep(0.01)
        for _ in range(3):
            hdl, _conn = await pool.claim({'timeout': 500})
            await asyncio.sleep(0.01)
            hdl.release()
        await asyncio.sleep(0.1)
        from_monitor = pool_monitor(pkg)
        ids = {'pool': pool.p_uuid,
               'set': next(iter(from_monitor.pm_sets)),
               'dns': next(iter(from_monitor.pm_dns_res))}
        collector = pkg.metrics.Collector({'shard': '0'})
        collector.counter('cueball_parity_total', 'claims').increment(value=3)
        collector.histogram('cueball_parity_ms', 'ms').observe(4.5)
        out = {}
        for path in PATHS:
            status, ctype, body = pkg.route(path.format(**ids), collector)
            if ctype.startswith('application/json'):
                body = json.loads(body)
                if path == '/kang/snapshot':
                    body['service'].pop('component')
            else:
                body = body.decode()
            out[path] = (status, ctype, body)
        pool.stop()
        cset.stop()
        res.stop()
        dns.stop()
        await asyncio.sleep(1.0)
        return out

    saved = pkg.dns.have_global_v6
    pkg.dns.have_global_v6 = lambda: False
    # A fresh ledger and trace ring, and no loop-lag sampler other tests
    # left armed: the routes read process-wide state.
    pkg.wiretap.disable_wiretap()
    pkg.trace.disable_tracing()
    lag = (dict(pkg.wiretap._lag_samplers), pkg.wiretap._lag_disabled_reason)
    pkg.wiretap._lag_samplers.clear()
    pkg.wiretap._lag_disabled_reason = None
    pkg.wiretap.enable_wiretap()
    pkg.trace.enable_tracing(ring_size=64, sample_rate=1.0)
    try:
        with set_aside(pkg):
            return ns.run(main(), seed=SEED)
    finally:
        pkg.trace.disable_tracing()
        pkg.wiretap.disable_wiretap()
        pkg.dns.have_global_v6 = saved
        pkg.wiretap._lag_samplers.update(lag[0])
        pkg.wiretap._lag_disabled_reason = lag[1]


def pool_monitor(pkg):
    return (j_http if pkg is JAX else t_http).pool_monitor


@contextlib.contextmanager
def set_aside(pkg):
    """The package's pool monitor holds only what the block registers,
    and after it what it held before: objects other tests left there
    are set aside, and a resolver that cbresolve's follow mode leaves
    running is dropped."""
    monitor = pool_monitor(pkg)
    regs = (monitor.pm_pools, monitor.pm_sets, monitor.pm_dns_res)
    kept = [dict(reg) for reg in regs]
    for reg in regs:
        reg.clear()
    try:
        yield
    finally:
        for reg, old in zip(regs, kept):
            reg.clear()
            reg.update(old)


def test_kang_routes_match_jax():
    want = _kang_record(JAX)
    got = _kang_record(PORT)
    assert got == want
    assert want['/kang/types'][2] == ['pool', 'set', 'dns_res']
    assert want['/kang/obj/pool/{pool}'][0] == 200
    assert want['/kang/traces'][2].count('\n') > 3
    assert want['/kang/transport?seam=bogus'][0] == 400
    assert want['/kang/nowhere'][0] == 404


@pytest.mark.parametrize('path', ['/kang/profile', '/kang/shards'])
def test_routes_not_yet_ported_answer_404(path):
    """The two routes that answered 404 until the profiler and the shard
    router were ported now answer as the JAX package's do, with no
    router started and nothing profiled; a POST is still a 405."""
    for prof, trace in ((j_profile, j_trace), (t_profile, t_trace)):
        prof.stop_sampler()
        prof.reset_samples()
        trace.disable_tracing()
    status, ctype, body = t_http.route('GET', path)
    assert (status, ctype, body) == j_http._route('GET', path, None)
    assert status == 200 and 'not yet ported' not in body.decode()
    assert t_http.route('POST', path)[0] == 405


def test_snapshot_names_the_port():
    status, _ctype, body = t_http.route('GET', '/kang/snapshot')
    assert status == 200
    assert json.loads(body)['service']['component'] == 'cueball_tpu_torch'


def test_serve_monitor_serves_the_object_routes(tmp_path):
    """The kang server through the transport seam, fetched from a
    thread: the object routes and ``/metrics`` of a collector."""
    import urllib.request

    async def main():
        collector = t_metrics.Collector()
        collector.counter('cueball_test_total', 'a counter').increment()
        server = await t_http.serve_monitor(collector=collector)
        port = server.sockets[0].getsockname()[1]
        try:
            def fetch(path):
                with urllib.request.urlopen(
                        'http://127.0.0.1:%d%s' % (port, path),
                        timeout=10) as r:
                    return r.status, r.read().decode()
            types_ = await asyncio.to_thread(fetch, '/kang/types')
            metrics = await asyncio.to_thread(fetch, '/metrics')
        finally:
            server.close()
        return types_, metrics

    (status, body), (m_status, m_body) = asyncio.run(main())
    assert status == 200 and json.loads(body) == ['pool', 'set', 'dns_res']
    assert m_status == 200 and 'cueball_test_total 1' in m_body
