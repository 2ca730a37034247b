"""A fleet of the port's connection pools whose backends come from DNS,
sampled on the card, with the service set changed mid-run: the way the
system is deployed, where every service's backends are listed in DNS.

A nameserver in-process on 127.0.0.1 answers UDP queries from a
``netsim.dns.SimZone`` (through ``parse_query`` and
``encode_response``), so discovery runs the port's DNS client and
resolver end to end over a real socket. ``SERVICES`` services,
``_http._tcp.svc00.fleet.test`` to ``svc63``, each name ``TARGETS`` SRV
targets ``b0.fleet.test`` to ``b7.fleet.test`` at the ports of HTTP
servers 0-7; each target has an A record of 127.0.0.1; SRV and A TTLs
are ``TTL`` seconds. One ``ConnectionPool`` per service is built from
its ``domain``, ``service`` and ``resolvers``, with ``spares`` 2,
``maximum`` 4 and both fleet actuations on, as in ``pool_fleet``.

``CONCURRENCY`` workers run ``claims`` claim / GET / release cycles
while a ``FleetSampler`` (control and health on) ticks every
``TICK_EVERY`` claims on the card, a twin over ``Shadow``\\ s of the
pools ticking just before it on another device. At claim ``swap_at``
the zone replaces ``b0`` by ``b8`` (server 8) in every service's SRV
set; the run waits, at most ``SWAP_TIMEOUT_S``, until every pool's
resolver has emitted ``removed`` for b0 and ``added`` for b8, then runs
the rest of the claims. Last, the port's ``HttpAgent`` makes
``AGENT_REQUESTS`` requests by hostname over the same nameserver, as
``inference_fleet_client.run_dns`` does.

The fleet is IPv4 only: the resolvers' probe for a global IPv6 address
is pinned off for the run, so the AAAA stage is skipped on every host
alike and no host interface is probed.

    python -m cueball_tpu_torch.examples.discovered_fleet [--device cpu] \\
        [--twin-device cpu] [--claims 2000]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random

from .. import dns_resolver as mod_dns_resolver
from .. import host
from .. import monitor as mod_monitor
from .. import trace as mod_trace
from .. import utils
from .._device import resolve_device
from ..entry import frozen_host
from ..netsim.dns import SimZone, encode_response, parse_query
from ..ops import fir
from ..parallel.sampler import FleetSampler
from ..pool import ConnectionPool
from ..resolver import srv_key
from . import inference_fleet_client
from .inference_fleet_client import RECOVERY, _agreement, _serve_fleet
from .pool_fleet import ShadowMonitor, _get

SERVICES = 64
TARGETS = 8            # SRV targets per service
SERVERS = TARGETS + 1  # server TARGETS takes over from server 0
SPARES = 2
MAXIMUM = 4
CLAIMS = 2000
CONCURRENCY = 32
TICK_EVERY = 20        # claims between two sampler ticks
TAPS = 32
TTL = 1                # seconds, SRV and A
SWAP_AT = 1000         # claims before the zone changes
SWAP_TIMEOUT_S = 10.0
AGENT_REQUESTS = 50
ZONE = 'fleet.test'
SERVICE = '_http._tcp'


def service_name(i: int) -> str:
    return 'svc%02d.%s' % (i, ZONE)


def target_name(j: int) -> str:
    return 'b%d.%s' % (j, ZONE)


class Nameserver(asyncio.DatagramProtocol):
    """A UDP nameserver answering every query from ``zone``; counts the
    queries it answered by type."""

    def __init__(self, zone: SimZone):
        self.zone = zone
        self.answered: dict = {}
        self.transport = None

    def connection_made(self, transport):
        self.transport = transport

    def datagram_received(self, data, addr):
        qid, domain, qtype, _edns = parse_query(data)
        rcode, answers, authority = self.zone.resolve(domain, qtype)
        self.transport.sendto(encode_response(
            qid, domain, qtype, rcode=rcode, answers=answers,
            authority=authority), addr)
        self.answered[qtype] = self.answered.get(qtype, 0) + 1


async def serve_zone(zone: SimZone) -> tuple:
    """(transport, Nameserver, port) of a nameserver for ``zone`` on
    127.0.0.1 and the running loop."""
    loop = asyncio.get_running_loop()
    transport, ns = await loop.create_datagram_endpoint(
        lambda: Nameserver(zone), local_addr=('127.0.0.1', 0))
    return transport, ns, transport.get_extra_info('sockname')[1]


def fleet_zone(services: int, ports: list, targets=range(TARGETS)) -> SimZone:
    """The zone of ``services`` services whose SRV sets name the
    ``targets`` (server indices into ``ports``), and an A record for
    every server."""
    zone = SimZone()
    for j in range(len(ports)):
        zone.add(target_name(j), 'A', '127.0.0.1', ttl=TTL)
    for i in range(services):
        set_targets(zone, i, ports, targets)
    return zone


def set_targets(zone: SimZone, i: int, ports: list, targets) -> None:
    """Replace service ``i``'s SRV set by ``targets``."""
    name = '%s.%s' % (SERVICE, service_name(i))
    zone.remove(name, 'SRV')
    for j in targets:
        zone.add(name, 'SRV', target_name(j), ttl=TTL, port=ports[j])


def backend_key(j: int, ports: list) -> str:
    """The resolvers' key for server ``j`` (``resolver.srv_key``)."""
    return srv_key({'name': target_name(j), 'port': ports[j],
                    'address': '127.0.0.1'})


class pinned_v4_only:
    """Context in which the resolvers see no global IPv6 address."""

    def __enter__(self):
        self._probe = mod_dns_resolver.have_global_v6
        mod_dns_resolver.have_global_v6 = lambda: False

    def __exit__(self, *exc):
        mod_dns_resolver.have_global_v6 = self._probe


async def wait_until(cond, timeout_s: float, what: str) -> float:
    """Poll ``cond`` every 5 ms; the seconds it took, or raise after
    ``timeout_s``."""
    t0 = utils.perf_seconds()
    while not cond():
        if utils.perf_seconds() - t0 > timeout_s:
            raise TimeoutError('%s: not within %.1f s' % (what, timeout_s))
        await asyncio.sleep(0.005)
    return utils.perf_seconds() - t0


async def run(device=None, twin_device='cpu', services: int = SERVICES,
              claims: int = CLAIMS, swap_at: int = SWAP_AT,
              concurrency: int = CONCURRENCY, tick_every: int = TICK_EVERY,
              taps: int = TAPS, agent_requests: int = AGENT_REQUESTS) -> dict:
    """Serve the HTTP servers and the nameserver, discover ``services``
    pools through it, run ``claims`` claims with the zone changed at
    claim ``swap_at``, then the agent's requests. Returns the counts,
    each tick's records, the FIR launches, the swap as each pool and
    the health table saw it, the nameserver's answers and the wall
    times."""
    dev = resolve_device(device)
    with pinned_v4_only():
        return await _run(dev, twin_device, services, claims, swap_at,
                          concurrency, tick_every, taps, agent_requests)


async def _run(dev, twin_device, services, claims, swap_at, concurrency,
               tick_every, taps, agent_requests) -> dict:
    srv, addrs = await _serve_fleet(['srv-%d' % j for j in range(SERVERS)])
    ports = [int(a.partition(':')[2]) for a in addrs]
    zone = fleet_zone(services, ports)
    ns_transport, ns, ns_port = await serve_zone(zone)
    resolvers = ['127.0.0.1@%d' % ns_port]
    old_key, new_key = backend_key(0, ports), backend_key(TARGETS, ports)
    monitor = mod_monitor.pool_monitor
    tracing = mod_trace.tracing_enabled()
    if not tracing:
        mod_trace.enable_tracing()       # feeds the health tables
    fleet, seen = [], []
    sampler = twin = None
    try:
        for i in range(services):
            pool = ConnectionPool({
                'domain': service_name(i), 'service': SERVICE,
                'resolvers': resolvers, 'spares': SPARES,
                'maximum': MAXIMUM, 'transport': 'asyncio',
                'recovery': RECOVERY, 'fleetActuation': True,
                'controlActuation': True})
            events = {'added': set(), 'removed': set()}
            pool.p_resolver.on('added',
                               lambda k, b, e=events: e['added'].add(k))
            pool.p_resolver.on('removed',
                               lambda k, e=events: e['removed'].add(k))
            fleet.append(pool)
            seen.append(events)
        discover_s = await wait_until(
            lambda: all(p.is_in_state('running') for p in fleet),
            SWAP_TIMEOUT_S, 'discovery')

        instant = [host.current_millis()]
        opts = {'host': frozen_host(instant), 'control': True,
                'health': True, 'actuate': True, 'taps': taps,
                'capacity': services}
        sampler = FleetSampler(dict(opts, monitor=monitor, device=dev))
        twin = (FleetSampler(dict(opts, monitor=ShadowMonitor(monitor),
                                  device=twin_device))
                if twin_device is not None else None)
        records, twin_records, tick_s = [], [], []

        def tick():
            instant[0] = host.current_millis()
            if twin is not None:
                twin_records.append(twin.sample_once())
            t0 = utils.perf_seconds()
            records.append(sampler.sample_once())
            tick_s.append(utils.perf_seconds() - t0)

        rng = random.Random(0)
        order = [rng.randrange(services) for _ in range(claims)]
        bodies: dict = {}
        failed, done = [], [0]

        async def worker(k, lo, hi):
            for c in range(lo + k, hi, concurrency):
                try:
                    hdl, conn = await fleet[order[c]].claim(
                        {'timeout': 10000})
                    try:
                        body = await _get(conn)
                    finally:
                        hdl.release()
                    bodies[body] = bodies.get(body, 0) + 1
                except Exception as e:
                    failed.append('claim %d: %r' % (c, e))
                done[0] += 1
                if done[0] % tick_every == 0:
                    tick()

        launches = fir.fir_apply_cuda.launches
        tick()                 # health tables join the sinks here
        t0 = utils.perf_seconds()
        await asyncio.gather(*(worker(k, 0, swap_at)
                               for k in range(concurrency)))
        claim_s = utils.perf_seconds() - t0
        answered_before = dict(ns.answered)
        for i in range(services):
            set_targets(zone, i, ports, range(1, TARGETS + 1))
        swap_s = await wait_until(
            lambda: all(old_key in e['removed'] and new_key in e['added']
                        for e in seen), SWAP_TIMEOUT_S, 'the swap')
        t0 = utils.perf_seconds()
        await asyncio.gather(*(worker(k, swap_at, claims)
                               for k in range(concurrency)))
        claim_s += utils.perf_seconds() - t0
        tick()
        launches = fir.fir_apply_cuda.launches - launches
        epoch = sampler.fs_ctrl_last['epoch']
        new_set = sorted((target_name(j), ports[j])
                         for j in range(1, TARGETS + 1))
        health = sampler.fs_health_monitor
        swap = {
            'seconds': swap_s,
            'pools_removed_b0': sum(old_key in e['removed'] for e in seen),
            'pools_added_b8': sum(new_key in e['added'] for e in seen),
            'pools_on_server0': sum(bool(p.p_connections.get(old_key))
                                    for p in fleet),
            'pools_listing_new_set': sum(
                sorted((b['name'], b['port']) for b in
                       monitor.get_pool(p.p_uuid)['backends'].values())
                == new_set for p in fleet),
            'health_rows': int(health.hm_rows),
            'b8_row': host.backend_index(new_key),
            'b8_in_health': new_key in records[-1]['health']['backends'],
        }
        reached = {
            'advisories': sum(p.p_fleet_advisory is not None and
                              p.p_fleet_advisory[1] == instant[0]
                              for p in fleet),
            'decisions': sum(p.p_ctrl_epoch == epoch for p in fleet),
            'applied': sum(r['control']['applied'] for r in records),
            'epoch': epoch}
        # Every SRV query after each pool's first is a refresh of its
        # service set.
        answered_claims = dict(ns.answered)
        refreshes = answered_claims.get('SRV', 0) - services
        agent = await inference_fleet_client.run_dns(
            inference_fleet_client.pool_layer(), service_name(0), SERVICE,
            agent_requests, resolvers=resolvers)
    finally:
        if sampler is not None:
            sampler.stop()
        if twin is not None:
            twin.stop()
        for p in fleet:
            p.stop()
        for s in srv:
            s.close()
        ns_transport.close()
        if not tracing:
            mod_trace.disable_tracing()
        await asyncio.sleep(0.05)
    served = {int(b[4:]): n for b, n in bodies.items()
              if b.startswith(b'srv-')}
    return {'served': sum(served.values()), 'by_server': served,
            'failed': failed, 'ticks': len(records), 'records': records,
            'twin_records': twin_records, 'fir_launches': launches,
            'reached': reached, 'swap': swap, 'agent': agent,
            'answered': answered_claims,
            'answered_before_swap': answered_before,
            'answered_with_agent': dict(ns.answered),
            'srv_refreshes': refreshes, 'discover_s': discover_s,
            'wall_s': claim_s, 'claims_per_s': claims / claim_s,
            'ms_per_tick': 1e3 * sum(tick_s) / len(tick_s),
            'device': str(dev)}


def main(device=None, twin_device='cpu', claims: int = CLAIMS) -> dict:
    """Run the fleet and print one JSON line of its counts and rates,
    the fleet aggregates' agreement with the twin among them."""
    res = asyncio.run(run(device, twin_device, claims=claims,
                          swap_at=claims // 2))
    agree, err = _agreement([r['fleet'] for r in res['records']],
                            [r['fleet'] for r in res['twin_records']])
    print(json.dumps({k: res[k] for k in (
        'served', 'by_server', 'ticks', 'fir_launches', 'reached', 'swap',
        'answered', 'srv_refreshes', 'claims_per_s', 'ms_per_tick',
        'device')} | {
        'failed': len(res['failed']), 'agent': res['agent'],
        'agree': agree, 'max_abs_err': err}))
    return res


if __name__ == '__main__':
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--device', default=None,
                   help='torch device (default: the CUDA card)')
    p.add_argument('--twin-device', default='cpu')
    p.add_argument('--claims', type=int, default=CLAIMS)
    args = p.parse_args()
    main(args.device, args.twin_device, args.claims)
