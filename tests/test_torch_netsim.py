"""The port's netsim (``cueball_tpu_torch.netsim``) and its
``transport.FabricTransport`` against the JAX package's.

Every run goes once over each package, on that package's own virtual
loop, one package after the other: the clock and loop primitives, the
fabric's link and fault models, and one seeded ``Scenario`` whose pool
discovers its backends through the package's ``DNSResolver`` over a
``SimWire`` zone and connects through ``FabricTransport`` (registered as
``'fabric'``), under a fault schedule of a partition, a gray link, a
heal and a change of the SRV set, with two herds of claims. The records
(the FSM transition trace, the fired schedule, every claim's outcome and
latency, the wire log, the pool's counters and the wire ledger) must be
equal.
"""

import asyncio
import json
import types

import pytest

pytest.importorskip('torch')

from cueball_tpu import dns_client as j_dc  # noqa: E402
from cueball_tpu import dns_resolver as j_dns  # noqa: E402
from cueball_tpu import netsim as j_netsim  # noqa: E402
from cueball_tpu import pool as j_pool  # noqa: E402
from cueball_tpu import profile as j_profile  # noqa: E402
from cueball_tpu import trace as j_trace  # noqa: E402
from cueball_tpu import transport as j_transport  # noqa: E402
from cueball_tpu import utils as j_utils  # noqa: E402
from cueball_tpu import wiretap as j_wiretap  # noqa: E402
from cueball_tpu_torch import dns_client as t_dc  # noqa: E402
from cueball_tpu_torch import dns_resolver as t_dns  # noqa: E402
from cueball_tpu_torch import netsim as t_netsim  # noqa: E402
from cueball_tpu_torch import pool as t_pool  # noqa: E402
from cueball_tpu_torch import profile as t_profile  # noqa: E402
from cueball_tpu_torch import trace as t_trace  # noqa: E402
from cueball_tpu_torch import transport as t_transport  # noqa: E402
from cueball_tpu_torch import utils as t_utils  # noqa: E402
from cueball_tpu_torch import wiretap as t_wiretap  # noqa: E402

JAX = types.SimpleNamespace(dc=j_dc, dns=j_dns, netsim=j_netsim, pool=j_pool,
                            profile=j_profile, trace=j_trace,
                            transport=j_transport, utils=j_utils,
                            wiretap=j_wiretap)
PORT = types.SimpleNamespace(dc=t_dc, dns=t_dns, netsim=t_netsim,
                             pool=t_pool, profile=t_profile, trace=t_trace,
                             transport=t_transport, utils=t_utils,
                             wiretap=t_wiretap)
RECOVERY = {'default': {'timeout': 500, 'retries': 2, 'delay': 50,
                        'maxDelay': 400}}
SRV = '_http._tcp.svc.sim'


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


def both(fn, *args):
    want = fn(JAX, *args)
    got = fn(PORT, *args)
    assert got == want
    return got


# -- the virtual clock and loop ---------------------------------------------

def _clock_record(pkg):
    ns, utils = pkg.netsim, pkg.utils
    before = (utils.get_clock(), utils.get_rng())

    async def main():
        loop = asyncio.get_running_loop()
        order = []
        for t, tag in ((3.0, 'c'), (1.0, 'a'), (2.0, 'b'), (1.0, 'a2')):
            loop.call_later(t, order.append, (tag, loop.time()))
        await asyncio.sleep(123.456)
        try:
            await asyncio.wait_for(asyncio.Event().wait(), timeout=7.0)
            timed_out = False
        except asyncio.TimeoutError:
            timed_out = True
        return {'order': order, 'now': loop.time(), 'timed_out': timed_out,
                'ms': utils.current_millis(), 'wall': utils.wall_time(),
                'rng': [utils.get_rng().random() for _ in range(4)],
                'virtual': isinstance(utils.get_clock(), ns.VirtualClock)}

    rec = ns.run(main(), seed=9)
    assert (utils.get_clock(), utils.get_rng()) == before
    with pytest.raises(ns.LoopStarvedError) as err:
        ns.run(asyncio.Event().wait(), seed=1)
    rec['starved'] = str(err.value)
    clock = ns.VirtualClock(start=5.0)
    clock.advance(2.5)
    with pytest.raises(ValueError):
        clock.advance(-1)
    rec['clock'] = (clock.monotonic(), clock.wall(), ns.VIRTUAL_EPOCH)
    return rec


def test_clock_and_loop_match_jax():
    rec = both(_clock_record)
    assert rec['virtual'] and rec['timed_out']
    assert [t for t, _ in rec['order']] == ['a', 'a2', 'b', 'c']


# -- the fabric's link and fault models --------------------------------------

def _backend(key, addr='10.0.0.1', port=80):
    return {'key': key, 'name': key, 'address': addr, 'port': port}


def _fabric_record(pkg, seed):
    ns = pkg.netsim

    async def main():
        loop = asyncio.get_running_loop()
        fabric = ns.Fabric()
        log = []

        def watch(tag, conn):
            for ev in ('connect', 'error', 'close'):
                conn.on(ev, lambda e=None, ev=ev: log.append(
                    (round(loop.time(), 9), tag, ev,
                     None if e is None else str(e))))
            return conn

        fabric.set_link('slow', latency_ms=250.0, jitter_ms=40.0)
        fabric.set_link('rst', connect='rst')
        fabric.set_link('hang', connect='hang')
        fabric.set_link('lossy', loss=0.5)
        for i in range(6):
            watch('slow%d' % i, fabric.constructor(_backend('slow')))
            watch('lossy%d' % i, fabric.constructor(_backend('lossy')))
        watch('rst', fabric.constructor(_backend('rst')))
        watch('hang', fabric.constructor(_backend('hang')))
        watch('b1', fabric.constructor(_backend('b1')))
        await asyncio.sleep(1.0)
        fabric.partition(['b1'])
        watch('late', fabric.constructor(_backend('b1')))
        await asyncio.sleep(2.0)
        fabric.heal()
        watch('healed', fabric.constructor(_backend('b1')))
        fabric.down('slow')
        await asyncio.sleep(1.0)
        for i in range(10):
            fabric.set_link('g%d' % i, service_ms=2.0)
        gray = fabric.set_gray(0.2, mult=100.0)
        times = [fabric.constructor(_backend('g%d' % i)).service_time_s()
                 for i in range(10)]
        manual = watch('manual', ns.ManualConnection(fabric, _backend('m')))
        await asyncio.sleep(0.5)
        manual.connect()
        await asyncio.sleep(0.1)
        return {'log': log, 'gray': gray, 'times': times,
                'live': sorted((c.key, c.connected)
                               for c in fabric.connections())}
    return ns.run(main(), seed=seed)


@pytest.mark.parametrize('seed', [2, 3])
def test_fabric_models_match_jax(seed):
    rec = both(_fabric_record, seed)
    assert any(ev == 'error' for _t, tag, ev, _e in rec['log']
               if tag == 'rst')
    assert rec['gray'] and max(rec['times']) >= 100 * min(rec['times'])


# -- one seeded scenario over Fabric and FabricTransport ---------------------

def _scenario_record(pkg, seed):
    ns = pkg.netsim
    fabric = ns.Fabric()
    zone = ns.SimZone()
    for i in range(1, 5):
        fabric.set_link('10.0.0.%d:80' % i, latency_ms=4.0 + i,
                        jitter_ms=2.0, service_ms=3.0)
        zone.add_srv_backend(SRV, 'b%d.sim' % i, 80, '10.0.0.%d' % i,
                             ttl=2, addr_ttl=2)
    wire = ns.SimWire(zone)
    transport = pkg.transport.FabricTransport(fabric, wire)
    sc = ns.Scenario('torch-parity', seed=seed)

    def drop_b4():
        zone.remove(SRV, 'SRV')
        for i in range(1, 4):
            zone.add(SRV, 'SRV', 'b%d.sim' % i, ttl=2, port=80)

    sc.at(3.0, 'partition b1', lambda: fabric.partition(['10.0.0.1:80']))
    sc.at(4.0, 'gray b2', lambda: fabric.set_gray(['10.0.0.2:80'],
                                                  mult=20.0))
    sc.at(6.0, 'heal', fabric.heal)
    sc.at(6.5, 'drop b4', drop_b4)

    async def main():
        loop = asyncio.get_running_loop()
        got = pkg.transport.get_transport('fabric')
        assert got is transport and got.available
        res = pkg.dns.DNSResolver({
            'domain': 'svc.sim', 'service': '_http._tcp',
            'resolvers': ['10.0.0.53'], 'recovery': RECOVERY,
            'dnsClient': pkg.dc.DnsClient(transport=wire)})
        res.start()
        pool = pkg.pool.ConnectionPool({
            'domain': 'svc.sim', 'transport': 'fabric', 'resolver': res,
            'spares': 2, 'maximum': 4, 'recovery': RECOVERY})
        while not pool.is_in_state('running'):
            await asyncio.sleep(0.01)
        first = await ns.herd(pool, 40, rate_per_s=15.0, timeout_ms=800)
        await asyncio.sleep(max(0.0, 5.0 - loop.time()))
        second = await ns.herd(pool, 60, rate_per_s=20.0, timeout_ms=800,
                               cohort=lambda i: i % 3)
        await asyncio.sleep(max(0.0, 10.0 - loop.time()))
        payload = pkg.dc.build_query(7, 'b1.sim', 'A')
        udp = await transport.dns_udp('10.0.0.53', 53, payload, 1.0)
        tcp = await transport.dns_tcp('10.0.0.53', 53, payload, 1.0)
        rec = {'first': first, 'second': second,
               'rates': ns.success_rates(second),
               'p50': ns.quantile([r['latency_ms'] for r in second], 0.5),
               'jain': ns.jain_index(ns.success_rates(second).values()),
               'counters': dict(pool.p_counters),
               'backends': sorted(b['name'] for b in res.list().values()),
               'wire': [udp, tcp], 'ledger': pkg.wiretap.snapshot(),
               'phases': pkg.profile.ledger_summary(
                   pkg.profile.phase_ledger())}
        pool.stop()
        res.stop()
        while not (pool.is_in_state('stopped') and
                   res.is_in_state('stopped')):
            await asyncio.sleep(0.01)
        return rec

    saved = pkg.dns.have_global_v6
    pkg.dns.have_global_v6 = lambda: False
    pkg.transport.register_transport('fabric', lambda: transport)
    pkg.wiretap.enable_wiretap()
    pkg.trace.enable_tracing(ring_size=512, sample_rate=1.0)
    try:
        rec = sc.run(main)
        rec['traces'] = [json.loads(line) for t in pkg.trace.trace_ring()
                         for line in t.ndjson_lines()][:50]
    finally:
        pkg.trace.disable_tracing()
        pkg.wiretap.disable_wiretap()
        pkg.transport._REGISTRY.pop('fabric')
        pkg.dns.have_global_v6 = saved
    rec.update(trace=sc.trace, fired=sc.fired, wire_log=wire.log)
    return rec


@pytest.mark.parametrize('seed', [7, 8])
def test_scenario_over_fabric_transport_matches_jax(seed):
    rec = both(_scenario_record, seed)
    assert [label for _t, label in rec['fired']] == [
        'partition b1', 'gray b2', 'heal', 'drop b4']
    assert rec['backends'] == ['b1.sim', 'b2.sim', 'b3.sim']
    assert sum(r['ok'] for r in rec['first']) > 30
    assert rec['ledger']['fabric']['connector']['events'] > 0
    assert rec['phases']['claims'] > 0 and rec['trace']


def test_get_transport_fabric_needs_a_fabric_as_in_jax():
    """As in the JAX package, ``'fabric'`` is not a default registry
    name (a fabric transport needs its fabric): the same refusal until
    one is registered, then the registered transport, available."""
    msgs = []
    for pkg in (JAX, PORT):
        with pytest.raises(ValueError) as err:
            pkg.transport.get_transport('fabric')
        msgs.append(str(err.value))
        fabric = pkg.netsim.Fabric()
        ft = pkg.transport.FabricTransport(fabric)
        assert pkg.transport.get_transport(ft) is ft and ft.available
        assert ft.host_ident() == 'netsim'
        pkg.transport.register_transport('fabric', lambda: ft)
        try:
            assert pkg.transport.get_transport('fabric') is ft
        finally:
            pkg.transport._REGISTRY.pop('fabric')
        with pytest.raises(NotImplementedError):
            asyncio.run(ft.dns_udp('10.0.0.53', 53, b'', 1.0))
    assert msgs[0] == msgs[1]


def test_herd_statistics_match_jax():
    outcomes = [{'cohort': c, 'ok': ok} for c, ok in (
        ('a', True), ('a', True), ('b', True), ('b', False), ('c', False))]
    for fn, args in ((lambda ns: ns.success_rates(outcomes), ()),
                     (lambda ns: ns.jain_index([1.0, 0.5, 0.0]), ()),
                     (lambda ns: [ns.quantile([5, 1, 9, 3], q)
                                  for q in (0.0, 0.3, 0.5, 1.0)], ())):
        assert fn(t_netsim, *args) == fn(j_netsim, *args)
