"""Pooled client for a fleet of equivalent inference servers, its pools
sampled by the port's ``FleetSampler``: the counterpart of the JAX
package's ``examples/inference_fleet_client.py``.

A host process (a request router, a data loader, an evaluation
harness) talks to many equivalent model servers through one pool: lease
based connection reuse, dead-backend detection with monitor probes,
jittered exponential backoff and CoDel shedding when the fleet
saturates. A ``FleetSampler`` samples every pool of the process each
tick and publishes the fleet's aggregates; here it is the port's, on
the card, ticked every ``TICK_EVERY`` requests and once after the last.

The pools are the port's own: its HTTP agent, static resolver and pool
monitor, with the sampler reading the layer's clock, backend registry
and loop lag through ``host.seam_over``. :func:`pool_layer` builds that
layer; given the JAX package's modules instead, it builds the same
layer over that package's pools (this module imports none of them), so
a test can run the example on either. The script
``examples_torch/inference_fleet_client.py`` runs :func:`main`:

    python examples_torch/inference_fleet_client.py [--requests 20] \\
        [--device cpu] [--twin-device cpu] [IP:PORT ...]

Without addresses it serves two HTTP servers of its own, in-process on
127.0.0.1. ``--twin-device`` ticks a second sampler on that device on
the same rows at the same instants and holds the fleet aggregates
against it. Or point it at a DNS service name instead of IPs
(:func:`run_dns`; no sampler is attached):

    python examples_torch/inference_fleet_client.py \
        --domain infer.svc.example.com --service _http._tcp \
        [--resolvers 10.0.0.53]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import types

import numpy as np

from .. import agent as mod_agent
from .. import host
from .. import monitor as mod_monitor
from .. import pool as mod_pool
from .. import resolver as mod_resolver
from .. import trace as mod_trace
from .. import utils as mod_utils
from .. import wiretap as mod_wiretap
from .._device import resolve_device
from ..entry import frozen_host
from ..ops import fir
from ..parallel.sampler import FleetSampler

RECOVERY = {
    # One policy object per operation class; exponential timeout and
    # delay with randomized spread decorrelate client herds.
    'default': {'timeout': 2000, 'retries': 3, 'delay': 250,
                'maxDelay': 5000, 'delaySpread': 0.2},
}
TICK_EVERY = 10      # requests between two sampler ticks
RTOL = ATOL = 1e-5   # fleet aggregates against a twin sampler
POOL_HOST = 'fleet.local'


def pool_layer(agent=mod_agent, resolver=mod_resolver, monitor=mod_monitor,
               utils=mod_utils, pool=mod_pool, trace=mod_trace,
               wiretap=mod_wiretap):
    """The pool layer of the example: the HTTP agent, the static
    resolver, the process-wide pool monitor, and the host seam over
    the layer's clock, tracer and loop lag. By default this package's
    own modules; a caller may pass another package's ``agent``,
    ``resolver``, ``monitor``, ``utils``, ``pool``, ``trace`` and
    ``wiretap`` (the JAX package's, say), which this module never
    imports."""
    return types.SimpleNamespace(
        HttpAgent=agent.HttpAgent, StaticIpResolver=resolver.StaticIpResolver,
        pool_monitor=monitor.pool_monitor,
        host=host.seam_over(utils, pool, trace, wiretap))


async def _answer(name: bytes, reader, writer) -> None:
    """HTTP/1.1 keep-alive: every request is answered with the server's
    name. The server closes its side once the client has closed: left
    open, the half-closed connection would wait for the garbage
    collector, whose finalizer closes it from whichever thread it runs
    on."""
    try:
        while True:
            line = await reader.readline()
            if not line:
                break
            if line in (b'\r\n', b'\n'):
                continue
            while (await reader.readline()) not in (b'\r\n', b'\n', b''):
                pass
            writer.write(b'HTTP/1.1 200 OK\r\nContent-Length: %d\r\n\r\n%s'
                         % (len(name), name))
            await writer.drain()
    except ConnectionError:
        pass
    finally:
        writer.close()


async def _serve_fleet(names=('srv-a', 'srv-b')) -> tuple:
    """(servers, 'IP:PORT' addresses) of one HTTP server per name, on
    127.0.0.1 and the running loop."""
    servers, addrs = [], []
    for name in names:
        s = await asyncio.start_server(
            lambda r, w, n=name.encode(): _answer(n, r, w), '127.0.0.1', 0)
        servers.append(s)
        addrs.append('127.0.0.1:%d' % s.sockets[0].getsockname()[1])
    return servers, addrs


def _agreement(fleets: list, twin: list) -> tuple:
    """(ticks whose every aggregate is within RTOL/ATOL of the twin's,
    the largest absolute difference) over the aggregates of
    ``fleets``."""
    agree, err = 0, 0.0
    for got, want in zip(fleets, twin):
        g = np.array([got[k] for k in got], np.float64)
        w = np.array([want[k] for k in got], np.float64)
        agree += bool(np.allclose(g, w, rtol=RTOL, atol=ATOL))
        err = max(err, float(np.abs(g - w).max()))
    return agree, err


async def run(layer, addrs=None, requests: int = 20, device=None,
              twin_device=None, twins=(), target_claim_delay=None) -> dict:
    """Send ``requests`` GETs through one pool over ``addrs`` (default:
    two servers of its own), the port's sampler on ``device`` (default
    the card) ticking every ``TICK_EVERY`` requests and once after the
    last. Every twin (a sampler on ``twin_device``, and each of
    ``twins``: anything with ``sample_once``) ticks right after it, at
    the same instant. Returns the counts, each tick's fleet aggregates,
    the twins' and how far they agree, and the FIR launches."""
    dev = resolve_device(device)
    servers = []
    if not addrs:
        servers, addrs = await _serve_fleet()
    backends = []
    for a in addrs:
        addr, _, port = a.partition(':')
        backends.append({'address': addr, 'port': int(port or 80)})
    agent = layer.HttpAgent({'defaultPort': backends[0]['port'],
                             'spares': 2, 'maximum': 8,
                             'recovery': RECOVERY,
                             'ping': '/healthz', 'pingInterval': 5000})
    # A custom resolver (static IPs) rides the public create_pool API;
    # the agent owns its lifecycle from here on.
    agent.create_pool(POOL_HOST, {
        'resolver': layer.StaticIpResolver({'backends': backends}),
        'targetClaimDelay': target_claim_delay})
    pool = agent.get_pool(POOL_HOST)

    # Each tick reads the layer's clock once; every sampler sees that
    # instant, so a twin is fed the very rows the sampler was.
    instant = [layer.host.current_millis()]
    opts = {'monitor': layer.pool_monitor,
            'host': frozen_host(instant, layer.host)}
    sampler = FleetSampler(dict(opts, device=dev))
    twins = list(twins)
    if twin_device is not None:
        twins.append(FleetSampler(dict(opts, device=twin_device)))
    layer.pool_monitor.attach_fleet_sampler(sampler)
    fleets, twin_fleets = [], [[] for _ in twins]

    def tick():
        instant[0] = layer.host.current_millis()
        fleets.append(sampler.sample_once()['fleet'])
        for twin, out in zip(twins, twin_fleets):
            out.append(twin.sample_once()['fleet'])

    launches = fir.fir_apply_cuda.launches
    ok = errs = 0
    per_backend = {}
    try:
        for i in range(requests):
            try:
                r = await agent.request('GET', POOL_HOST, '/')
                ok += 1
                body = r.body[:40]
                per_backend[body] = per_backend.get(body, 0) + 1
            except Exception as e:
                errs += 1
                print('request %d failed: %r' % (i, e))
            if (i + 1) % TICK_EVERY == 0:
                tick()
        tick()                 # a final tick, so short runs report too
        launches = fir.fir_apply_cuda.launches - launches
        stats = pool.get_stats()
    finally:
        if layer.pool_monitor.pm_fleet is sampler:
            layer.pool_monitor.detach_fleet_sampler()
        sampler.stop()
        for twin in twins:
            twin.stop()
        await agent.stop()
        for s in servers:
            s.close()

    print('done: %d ok, %d failed' % (ok, errs))
    for body, count in sorted(per_backend.items()):
        print('  %4d x %r' % (count, body))
    print('pool stats:', stats)
    fleet = fleets[-1]
    print('fleet telemetry (%d ticks on %s, batched over %d pool(s)): %s' % (
        len(fleets), dev, int(fleet['n_pools']),
        {k: round(v, 2) for k, v in fleet.items()}))
    agree, max_err = [], []
    for twin, out in zip(twins, twin_fleets):
        a, e = _agreement(fleets, out)
        agree.append(a)
        max_err.append(e)
        print('fleet aggregates agree with %s on %d/%d ticks (max abs err '
              '%.3e)' % (getattr(twin, 'fs_device', 'the twin'), a,
                         len(fleets), e))
    return {'ok': ok, 'failed': errs, 'per_backend': per_backend,
            'ticks': len(fleets), 'fleets': fleets, 'twins': twin_fleets,
            'agree': agree, 'max_abs_err': max_err, 'fir_launches': launches,
            'pool_stats': stats}


async def run_dns(layer, domain, service, n_requests, resolvers=None) -> dict:
    """Send ``n_requests`` GETs by hostname to ``domain``, whose
    backends the agent discovers in DNS (the ``service`` SRV records,
    falling back to its A/AAAA records) through ``resolvers`` (default:
    the host's ``/etc/resolv.conf``). Returns the counts."""
    agent = layer.HttpAgent({'defaultPort': 80, 'spares': 2, 'maximum': 8,
                             'recovery': RECOVERY, 'service': service,
                             'resolvers': resolvers,
                             'initialDomains': [domain]})
    ok = errs = 0
    try:
        for i in range(n_requests):
            try:
                await agent.request('GET', domain, '/')
                ok += 1
            except Exception as e:
                errs += 1
                print('request %d failed: %r' % (i, e))
    finally:
        await agent.stop()
    print('done: %d ok, %d failed' % (ok, errs))
    return {'ok': ok, 'failed': errs}


def main(layer=None, argv=None) -> int:
    """The example's command line over a :func:`pool_layer` (default:
    this package's own). Prints, last, one JSON line of the run's
    counts; exits 1 when a request failed or a twin disagreed."""
    layer = layer or pool_layer()
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('addrs', nargs='*', metavar='IP[:PORT]',
                   help='backends (default: two servers in-process)')
    p.add_argument('--domain', help='DNS mode: service domain')
    p.add_argument('--service', default='_http._tcp')
    p.add_argument('--resolvers', default=None,
                   help='DNS mode: comma-separated nameservers (default: '
                        '/etc/resolv.conf)')
    p.add_argument('--requests', type=int, default=20)
    p.add_argument('--device', default=None,
                   help='torch device (default: the CUDA card)')
    p.add_argument('--twin-device', default=None,
                   help='also tick a sampler on this device and hold the '
                        'fleet aggregates against it')
    p.add_argument('--target-claim-delay', type=int, default=None,
                   help='enable CoDel shedding at this sojourn (ms)')
    args = p.parse_args(argv)
    if args.domain:
        resolvers = (args.resolvers.split(',') if args.resolvers
                     else None)
        res = asyncio.run(run_dns(layer, args.domain, args.service,
                                  args.requests, resolvers))
        print(json.dumps(res))
        return 0 if res['failed'] == 0 else 1
    res = asyncio.run(run(layer, args.addrs, args.requests, args.device,
                          args.twin_device,
                          target_claim_delay=args.target_claim_delay))
    print(json.dumps({k: res[k] for k in (
        'ok', 'failed', 'ticks', 'agree', 'max_abs_err', 'fir_launches')}
        | {'fleet': res['fleets'][-1]}))
    good = res['failed'] == 0 and all(a == res['ticks'] for a in res['agree'])
    return 0 if good else 1
