"""A fleet of the port's connection pools behind its shard router, each
shard's pools sampled on the card by that shard's own sampler: the
pool fleet of ``pool_fleet`` spread over the event loops of a
``shard.FleetRouter``.

``POOLS`` ``ConnectionPool``\\ s over ``SERVERS`` HTTP servers of its
own, in-process on 127.0.0.1, are made through ``router.create_pool``
on a ``FleetRouter({'shards': SHARDS, 'backend': 'thread'})``: each
lands on the shard loop its key hashes to, with a ``StaticIpResolver``
over ``PER_POOL`` servers, ``spares`` 2, ``maximum`` 4 and both fleet
actuations on. ``CONCURRENCY`` workers run ``claims`` claim / GET /
release cycles through ``router.claim`` (the GET and the release run on
the owning shard's loop). Every ``SAMPLE_EVERY`` claims the router runs
one ``sample_fleet`` pass, and every ``CONTROL_EVERY`` claims also a
``control_fleet`` and a ``health_fleet`` pass: each pass ticks one
``FleetSampler`` per shard on that shard's loop, so one FIR launch per
shard and pass on the card. Claims pause while a pass runs, as the
loop of ``pool_fleet`` does while its sampler ticks.

With ``twin_device`` set, every shard's card sampler is a
:class:`TwinnedSampler`: on each tick, in the same job on its shard's
loop and at the same instant, a twin sampler on ``twin_device`` ticks
first over :class:`~.pool_fleet.Shadow`\\ s of that shard's pools, so
both see the same rows and only the card's sampler acts.

The claim-path profiler's SIGPROF sampler is armed and a
``debug.LoopAffinityChecker`` installed across the claims; after them
the run reads the merged profile and wiretap records, the flamegraph,
``GET /kang/shards`` and ``GET /kang/profile`` from ``serve_monitor``,
``router.snapshot()`` and ``dump_fsm_histories()``.

    python -m cueball_tpu_torch.examples.sharded_fleet [--device cpu] \\
        [--twin-device cpu] [--claims 2000]
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import random
import urllib.request

from .. import debug as mod_debug
from .. import host
from .. import http_server
from .. import monitor as mod_monitor
from .. import profile as mod_profile
from .. import trace as mod_trace
from .. import utils
from .._device import resolve_device
from ..entry import frozen_host
from ..ops import fir
from ..parallel.sampler import FleetSampler
from ..pool import ConnectionPool
from ..resolver import StaticIpResolver
from ..shard import FleetRouter
from .inference_fleet_client import RECOVERY, _agreement, _serve_fleet
from .pool_fleet import ShadowMonitor, _get

SHARDS = 4
POOLS = 64
SERVERS = 8
PER_POOL = 4           # backends per pool
SPARES = 2
MAXIMUM = 4
CLAIMS = 2000
CONCURRENCY = 32
SAMPLE_EVERY = 20      # claims between two sample_fleet passes
CONTROL_EVERY = 100    # claims between two control + health passes
#: The samplers' FIR length, as in ``pool_fleet``: a row is offered
#: advisories and decisions once its window is full.
TAPS = 32


class TwinnedSampler(FleetSampler):
    """A shard's card sampler that ticks ``twin`` just before each of
    its own ticks, in the same call: on the shard's loop nothing runs
    between the two, so both read the same rows. The twin takes on the
    planes the router turns on; both records of every tick are kept in
    ``ts_records``."""

    def __init__(self, options: dict, twin: FleetSampler):
        super().__init__(options)
        self.ts_twin = twin
        self.ts_records: list = []     # (card record, twin record)

    def sample_once(self):
        twin = self.ts_twin
        twin.fs_control, twin.fs_health = self.fs_control, self.fs_health
        want = twin.sample_once()
        got = super().sample_once()
        self.ts_records.append((got, want))
        return got

    def stop(self):
        self.ts_twin.stop()
        super().stop()


def _pool_factory(i: int, backends: list):
    """The zero-argument factory of pool ``i``, run on its shard's
    loop: (pool, its started resolver)."""
    def build():
        res = StaticIpResolver({'backends': [
            backends[(i + j) % len(backends)]
            for j in range(min(PER_POOL, len(backends)))]})
        res.start()
        return ConnectionPool({
            'domain': 'pool-%d.fleet.local' % i, 'spares': SPARES,
            'maximum': MAXIMUM, 'transport': 'asyncio', 'resolver': res,
            'recovery': RECOVERY, 'fleetActuation': True,
            'controlActuation': True}), res
    return build


async def _until_running(pool, timeout_s: float = 10.0):
    deadline = asyncio.get_running_loop().time() + timeout_s
    while not pool.is_in_state('running'):
        if asyncio.get_running_loop().time() > deadline:
            raise RuntimeError('pool %s did not start: %s'
                               % (pool.p_domain, pool.get_state()))
        await asyncio.sleep(0.005)


async def _stop_shard_pools(recs):
    """Stop a shard's pools and resolvers on its loop, and wait until
    every pool has stopped (and so left the pool monitor)."""
    for rec in recs:
        rec.pool.stop()
        rec.aux[0].stop()
    for rec in recs:
        while not rec.pool.is_in_state('stopped'):
            await asyncio.sleep(0.005)


def _fetch(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


async def run(device=None, twin_device='cpu', shards: int = SHARDS,
              pools: int = POOLS, servers: int = SERVERS,
              claims: int = CLAIMS, concurrency: int = CONCURRENCY,
              sample_every: int = SAMPLE_EVERY,
              control_every: int = CONTROL_EVERY, taps: int = TAPS) -> dict:
    """Serve ``servers`` HTTP servers, start the router, make ``pools``
    pools through it, run ``claims`` claims with the passes between
    them, read the surfaces, and tear it all down. Returns the counts,
    every pass (its kind, its reduced row and each shard's card and
    twin records), the FIR launches, what reached the pools, the
    profiler's and the affinity checker's findings, the surfaces and
    the wall times."""
    dev = resolve_device(device)
    srv, addrs = await _serve_fleet(['srv-%d' % i for i in range(servers)])
    backends = [{'address': a.partition(':')[0],
                 'port': int(a.partition(':')[2])} for a in addrs]
    tracing = mod_trace.tracing_enabled()
    if not tracing:
        mod_trace.enable_tracing()       # feeds the health tables
    instant = [host.current_millis()]
    opts = {'device': dev, 'host': frozen_host(instant), 'actuate': True,
            'taps': taps, 'capacity': pools}
    router = FleetRouter(dict(opts, shards=shards, backend='thread'))
    await router.start()
    kang = await http_server.serve_monitor()
    base = 'http://127.0.0.1:%d' % kang.sockets[0].getsockname()[1]
    checker = mod_debug.LoopAffinityChecker()
    names = ['pool-%d' % i for i in range(pools)]
    try:
        for i, name in enumerate(names):
            await router.create_pool(name, factory=_pool_factory(i, backends))
        for name in names:
            await router.submit(name, _until_running)
        placement = {name: (router.get_pool(name).p_shard,
                            router.shard_of(name)) for name in names}
        if twin_device is not None:
            for sid in range(shards):
                twin = FleetSampler(dict(
                    opts, device=twin_device, shard=sid,
                    monitor=ShadowMonitor(mod_monitor.pool_monitor)))
                router.fr_samplers[sid] = TwinnedSampler(
                    dict(router.fr_runtime.rt_options, shard=sid), twin)

        passes, pass_s = [], []
        lock = asyncio.Lock()
        gate = asyncio.Event()
        gate.set()
        idle = asyncio.Event()
        idle.set()
        inflight = [0]

        async def run_pass(kind):
            instant[0] = host.current_millis()
            t0 = utils.perf_seconds()
            row = await getattr(router, kind + '_fleet')()
            pass_s.append((kind, utils.perf_seconds() - t0))
            passes.append({'kind': kind, 'row': row, 'shards': [
                router.fr_samplers[sid].ts_records[-1]
                if twin_device is not None else None
                for sid in range(shards)]})

        async def at_claim(n):
            # Claims pause while the passes run: the pass waits until
            # none is in flight.
            async with lock:
                gate.clear()
                await idle.wait()
                await run_pass('sample')
                if n % control_every == 0:
                    await run_pass('control')
                    await run_pass('health')
                gate.set()

        rng = random.Random(0)
        order = [rng.randrange(pools) for _ in range(claims)]
        served, failed, done = [0], [], [0]
        by_shard = [0] * shards

        async def worker(k):
            for c in range(k, claims, concurrency):
                await gate.wait()
                inflight[0] += 1
                idle.clear()
                name = names[order[c]]
                try:
                    claim = await router.claim(name, {'timeout': 10000})
                    try:
                        body = await router.submit(
                            name, lambda _pool, conn: _get(conn),
                            claim.connection)
                    finally:
                        await claim.release()
                    if body.startswith(b'srv-'):
                        served[0] += 1
                        by_shard[claim.rc_shard] += 1
                    else:
                        failed.append('claim %d: body %r' % (c, body))
                except Exception as e:
                    failed.append('claim %d: %r' % (c, e))
                inflight[0] -= 1
                if not inflight[0]:
                    idle.set()
                done[0] += 1
                if done[0] % sample_every == 0:
                    await at_claim(done[0])

        launches = fir.fir_apply_cuda.launches
        mod_profile.reset_samples()
        armed = mod_profile.start_sampler()
        sampler_stats = mod_profile.sampler_stats()
        # Garbage of this process's running loops left by earlier work
        # is collected now, not on some thread during the checked
        # claims.
        gc.collect()
        checker.install()
        try:
            t0 = utils.perf_seconds()
            await asyncio.gather(*(worker(k) for k in range(concurrency)))
            wall_s = utils.perf_seconds() - t0
        finally:
            checker.uninstall()
            if armed:
                mod_profile.stop_sampler()
        launches = fir.fir_apply_cuda.launches - launches
        profiler = {'armed': armed, 'at_start': sampler_stats,
                    'stats': mod_profile.sampler_stats(),
                    'flamegraph': mod_profile.flamegraph()}

        reached = {'applied': sum(p['row']['applied'] for p in passes
                                  if p['kind'] == 'control'),
                   'decisions': 0, 'advisories': 0}
        for name in names:
            pool = router.get_pool(name)
            last = router.fr_samplers[pool.p_shard].fs_ctrl_last
            reached['decisions'] += bool(
                last is not None and pool.p_ctrl_epoch == last['epoch'])
            reached['advisories'] += (pool.p_fleet_advisory is not None and
                                      pool.p_fleet_advisory[1] == instant[0])
        merged = {'profile': await router.profile_fleet(),
                  'wiretap': await router.wiretap_fleet()}
        snapshot = json.loads(json.dumps(router.snapshot(),
                                         default=http_server._json_default))
        kang_shards, kang_profile = await asyncio.gather(
            asyncio.to_thread(_fetch, base + '/kang/shards'),
            asyncio.to_thread(_fetch, base + '/kang/profile'))
        dump = mod_debug.dump_fsm_histories()
    finally:
        kang.close()
        by_sid: dict = {}
        for rec in router.fr_pools.values():
            if rec.pool is not None:
                by_sid.setdefault(rec.shard_id, []).append(rec)
        await asyncio.gather(*(router.run_on(sid, _stop_shard_pools, recs)
                               for sid, recs in by_sid.items()))
        await router.stop()
        for s in srv:
            s.close()
        if not tracing:
            mod_trace.disable_tracing()
    samples = [s for kind, s in pass_s if kind == 'sample']
    return {'served': served[0], 'failed': failed, 'by_shard': by_shard,
            'passes': passes, 'fir_launches': launches,
            'placement': placement, 'reached': reached,
            'profiler': profiler, 'violations': checker.violations,
            'marshals': sorted(checker.marshals_exercised),
            'merged': merged, 'snapshot': snapshot,
            'kang_shards': json.loads(kang_shards),
            'kang_profile': kang_profile.decode(), 'dump': dump,
            'wall_s': wall_s, 'claims_per_s': claims / wall_s,
            'ms_per_sample_pass': 1e3 * sum(samples) / len(samples),
            'launches_per_pass': launches / len(passes),
            'device': str(dev)}


def main(device=None, twin_device='cpu', claims: int = CLAIMS) -> dict:
    """Run the fleet and print one JSON line of its counts and rates,
    the sample passes' agreement with the twins among them."""
    res = asyncio.run(run(device, twin_device, claims=claims))
    rows = [p for p in res['passes'] if p['kind'] == 'sample']
    out = {k: res[k] for k in (
        'served', 'by_shard', 'fir_launches', 'reached', 'claims_per_s',
        'ms_per_sample_pass', 'launches_per_pass', 'device')}
    out.update(failed=len(res['failed']), passes=len(res['passes']),
               violations=len(res['violations']),
               profiler_samples=res['profiler']['stats']['samples'])
    if twin_device is not None:
        got = [s[0]['fleet'] for p in rows for s in p['shards']]
        want = [s[1]['fleet'] for p in rows for s in p['shards']]
        out['agree'], out['max_abs_err'] = _agreement(got, want)
    print(json.dumps(out))
    return res


if __name__ == '__main__':
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--device', default=None,
                   help='torch device (default: the CUDA card)')
    p.add_argument('--twin-device', default='cpu')
    p.add_argument('--claims', type=int, default=CLAIMS)
    args = p.parse_args()
    main(args.device, args.twin_device, args.claims)
