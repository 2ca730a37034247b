"""A fleet of the port's connection pools sampled on the card, with the
control step's decisions acted on by the pools: the whole loop in one
process.

``POOLS`` ``ConnectionPool``s over ``SERVERS`` HTTP servers of its own,
in-process on 127.0.0.1, each pool with a ``StaticIpResolver`` over
``PER_POOL`` of them, ``spares`` 2, ``maximum`` 4, and both fleet
actuations on. ``CONCURRENCY`` workers run ``claims`` claim / GET /
release cycles over seeded pools while one ``FleetSampler`` (control
and health on, the claim tracer feeding its health table) ticks every
``TICK_EVERY`` claims: its FIR runs on the card, its advisories reach
the pools through ``receive_fleet_advisory`` and its decisions through
``apply_control_decision``.

A twin sampler on another device (``twin_device``) ticks just before it
at the same instant, over shadows of the same pools: a shadow reads
through to its pool and drops the twin's advisories and decisions, so
both samplers see the same rows and only the card's sampler acts.

    python -m cueball_tpu_torch.examples.pool_fleet [--device cpu] \\
        [--twin-device cpu] [--claims 2000]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random

from .. import host
from .. import monitor as mod_monitor
from .. import resolver as mod_resolver
from .. import trace as mod_trace
from .. import utils
from .._device import resolve_device
from ..entry import frozen_host
from ..ops import fir
from ..parallel.sampler import FleetSampler
from ..pool import ConnectionPool
from .inference_fleet_client import RECOVERY, _agreement, _serve_fleet

POOLS = 64
SERVERS = 8
PER_POOL = 4           # backends per pool
SPARES = 2
MAXIMUM = 4
CLAIMS = 2000
CONCURRENCY = 32
TICK_EVERY = 20        # claims between two sampler ticks
#: The sampler's FIR length. A row is offered advisories and decisions
#: once its window is full; 32 taps leave most of a 2,000-claim run
#: (100 ticks) actuated.
TAPS = 32
REQUEST = b'GET / HTTP/1.1\r\nHost: fleet.local\r\n\r\n'


class Shadow:
    """A pool as the twin sampler sees it: every read goes to ``pool``;
    the twin's advisories and decisions are dropped."""

    def __init__(self, pool):
        self._pool = pool

    def __getattr__(self, name):
        return getattr(self._pool, name)

    def receive_fleet_advisory(self, filtered, at_ms=None):
        pass

    def apply_control_decision(self, epoch, **decision):
        return False


class ShadowMonitor:
    """The pools of ``monitor`` as :class:`Shadow`\\ s, in its order and
    with its generation."""

    def __init__(self, monitor):
        self._monitor = monitor
        self._shadows: dict = {}

    @property
    def pm_generation(self):
        return self._monitor.pm_generation

    @property
    def pm_pools(self):
        pools = self._monitor.pm_pools
        for uuid, pool in pools.items():
            if uuid not in self._shadows:
                self._shadows[uuid] = Shadow(pool)
        return {uuid: self._shadows[uuid] for uuid in pools}


async def _get(conn) -> bytes:
    """One HTTP/1.1 GET over a claimed keep-alive connection; the
    body."""
    conn.writer.write(REQUEST)
    await conn.writer.drain()
    await conn.reader.readline()
    length = 0
    while True:
        line = await conn.reader.readline()
        if line in (b'\r\n', b'\n', b''):
            break
        name, _, value = line.partition(b':')
        if name.strip().lower() == b'content-length':
            length = int(value)
    return await conn.reader.readexactly(length)


async def run(device=None, twin_device='cpu', pools: int = POOLS,
              servers: int = SERVERS, claims: int = CLAIMS,
              concurrency: int = CONCURRENCY, tick_every: int = TICK_EVERY,
              taps: int = TAPS) -> dict:
    """Serve ``servers`` HTTP servers, build ``pools`` pools over them,
    run ``claims`` claims and tick the sampler (and its twin) every
    ``tick_every`` claims, once before the first claim and once after
    the last. Returns the counts, each tick's records, the FIR
    launches, the advisories and decisions that reached the pools and
    the wall times."""
    dev = resolve_device(device)
    srv, addrs = await _serve_fleet(['srv-%d' % i for i in range(servers)])
    backends = [{'address': a.partition(':')[0],
                 'port': int(a.partition(':')[2])} for a in addrs]
    monitor = mod_monitor.pool_monitor
    tracing = mod_trace.tracing_enabled()
    if not tracing:
        mod_trace.enable_tracing()       # feeds the health tables
    resolvers, fleet = [], []
    for i in range(pools):
        res = mod_resolver.StaticIpResolver({'backends': [
            backends[(i + j) % servers]
            for j in range(min(PER_POOL, servers))]})
        res.start()
        resolvers.append(res)
        fleet.append(ConnectionPool({
            'domain': 'pool-%d.fleet.local' % i, 'spares': SPARES,
            'maximum': MAXIMUM, 'transport': 'asyncio', 'resolver': res,
            'recovery': RECOVERY, 'fleetActuation': True,
            'controlActuation': True}))

    instant = [host.current_millis()]
    opts = {'host': frozen_host(instant), 'control': True, 'health': True,
            'actuate': True, 'taps': taps, 'capacity': pools}
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
    order = [rng.randrange(pools) for _ in range(claims)]
    served, failed, done = [0], [], [0]
    launches = fir.fir_apply_cuda.launches

    async def worker(k):
        for c in range(k, claims, concurrency):
            try:
                hdl, conn = await fleet[order[c]].claim({'timeout': 10000})
                try:
                    body = await _get(conn)
                finally:
                    hdl.release()
                if body.startswith(b'srv-'):
                    served[0] += 1
                else:
                    failed.append('claim %d: body %r' % (c, body))
            except Exception as e:
                failed.append('claim %d: %r' % (c, e))
            done[0] += 1
            if done[0] % tick_every == 0:
                tick()

    try:
        for p in fleet:
            while not p.is_in_state('running'):
                await asyncio.sleep(0.005)
        tick()                 # health tables join the sinks here
        t0 = utils.perf_seconds()
        await asyncio.gather(*(worker(k) for k in range(concurrency)))
        wall_s = utils.perf_seconds() - t0
        tick()
        launches = fir.fir_apply_cuda.launches - launches
        epoch = sampler.fs_ctrl_last['epoch']
        reached = {
            'advisories': sum(p.p_fleet_advisory is not None and
                              p.p_fleet_advisory[1] == instant[0]
                              for p in fleet),
            'decisions': sum(p.p_ctrl_epoch == epoch for p in fleet),
            'applied': sum(r['control']['applied'] for r in records),
            'epoch': epoch}
    finally:
        sampler.stop()
        if twin is not None:
            twin.stop()
        for p in fleet:
            p.stop()
        for res in resolvers:
            res.stop()
        for s in srv:
            s.close()
        if not tracing:
            mod_trace.disable_tracing()
        await asyncio.sleep(0.05)
    return {'served': served[0], 'failed': failed, 'ticks': len(records),
            'records': records, 'twin_records': twin_records,
            'fir_launches': launches, 'reached': reached,
            'wall_s': wall_s, 'claims_per_s': claims / wall_s,
            'ms_per_tick': 1e3 * sum(tick_s) / len(tick_s),
            'device': str(dev)}


def main(device=None, twin_device='cpu', claims: int = CLAIMS) -> dict:
    """Run the fleet and print one JSON line of its counts and rates,
    the fleet aggregates' agreement with the twin among them."""
    res = asyncio.run(run(device, twin_device, claims=claims))
    agree, err = _agreement([r['fleet'] for r in res['records']],
                            [r['fleet'] for r in res['twin_records']])
    print(json.dumps({k: res[k] for k in (
        'served', 'ticks', 'fir_launches', 'reached', 'claims_per_s',
        'ms_per_tick', 'device')} | {
        'failed': len(res['failed']), 'agree': agree, 'max_abs_err': err}))
    return res


if __name__ == '__main__':
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--device', default=None,
                   help='torch device (default: the CUDA card)')
    p.add_argument('--twin-device', default='cpu')
    p.add_argument('--claims', type=int, default=CLAIMS)
    args = p.parse_args()
    main(args.device, args.twin_device, args.claims)
