"""FleetRouter: K worker shards behind a consistent-hash claim router;
this package's copy of the JAX package's ``shard.router``, whose fleet
passes run this package's samplers (``FleetRuntime``) on the card.

The router owns routing state only — a ``HashRing`` mapping pool keys
to shard ids, one ``ShardWorker`` + ``ShardFSM`` per shard, and a
record per pool (name, key, owning shard, and how to rebuild it). All
pool/FSM policy runs unchanged inside the owning shard's loop: a
claim or release NEVER crosses a loop boundary on the hot path. The
only cross-shard traffic is pool create/destroy, telemetry sampling,
trace/metric export, and lifecycle control.

Hot-path contract per backend:

- ``inline``: routing is a dict lookup plus a direct ``claim_cb``
  call on the caller's own loop (this is what netsim scenarios use,
  and why sharded runs replay byte-identical to plain ones).
- ``thread``: ``claim_cb``/``claim`` marshal once onto the shard loop
  and the callback marshals once back; CPU-bound users should instead
  ``submit()`` the whole claim/release loop into the shard.
- ``spawn``: jobs are ``'module:function'`` spec strings executed in
  the child process (closures don't pickle); per-claim routing is not
  offered — the unit of dispatch is a job.

The fleet passes (``sample_fleet``, ``control_fleet``,
``health_fleet``) tick one ``FleetSampler`` per shard on that shard's
loop through a :class:`~.fleet.FleetRuntime`, whose samplers are the
router's ``fr_samplers``. Every option the router does not read itself
goes to those samplers: ``device`` (default the CUDA card; without one
the first pass raises), ``monitor``, ``host``, ``objectives``,
``interval``, ``taps``, ``capacity``, ``actuate``, ``mesh``, ...
"""

from __future__ import annotations

import asyncio

from ..errors import CueBallError, ShardDeadError
from .fleet import FleetRuntime
from .ring import HashRing
from .worker import (InlineWorker, ShardFSM, ShardWorker,  # noqa: F401
                     ThreadWorker)

_BACKENDS = ('thread', 'inline', 'spawn')
#: The options the router reads; the rest go to the shard samplers.
_ROUTER_OPTIONS = ('shards', 'backend', 'seed', 'affinity', 'replicas')
#: Where spawn children find the jobs the router dispatches by spec.
_PROC = __name__.rpartition('.')[0] + '.proc'

# Routers that are started and not yet stopped; the debug/kang/metrics
# surfaces walk this to merge per-shard views into one output.
_ACTIVE_ROUTERS: list = []


def active_routers() -> list:
    return list(_ACTIVE_ROUTERS)


class _PoolRecord:
    __slots__ = ('name', 'key', 'shard_id', 'options', 'factory',
                 'pool', 'aux')

    def __init__(self, name, key, shard_id, options, factory):
        self.name = name
        self.key = key
        self.shard_id = shard_id
        self.options = options
        self.factory = factory
        self.pool = None
        self.aux = None


class RoutedClaim:
    """Handle returned by ``FleetRouter.claim``: the pool's real claim
    handle plus enough routing to release it on the owning shard's
    loop (releasing from the caller's loop would run pool timers on
    the wrong loop)."""

    __slots__ = ('rc_router', 'rc_name', 'rc_shard', 'handle',
                 'connection')

    def __init__(self, router, name, shard_id, handle, connection):
        self.rc_router = router
        self.rc_name = name
        self.rc_shard = shard_id
        self.handle = handle
        self.connection = connection

    async def release(self):
        await self.rc_router.submit(self.rc_name,
                                    lambda _pool: self.handle.release())

    async def close(self):
        await self.rc_router.submit(self.rc_name,
                                    lambda _pool: self.handle.close())


class FleetRouter:
    """K event-loop shards, each owning a disjoint set of pools."""

    def __init__(self, options: dict | None = None):
        options = dict(options or {})
        self.fr_nshards = int(options.get('shards', 1))
        if self.fr_nshards < 1:
            raise ValueError('shards must be >= 1')
        self.fr_backend = options.get('backend', 'thread')
        if self.fr_backend not in _BACKENDS:
            raise ValueError('backend must be one of %r' % (_BACKENDS,))
        self.fr_seed = int(options.get('seed', 0))
        self.fr_affinity = options.get('affinity')  # list[int] | None
        self.fr_ring = HashRing(
            self.fr_nshards,
            replicas=int(options.get('replicas', 64)),
            seed=self.fr_seed)
        self.fr_loop = None
        self.fr_workers: dict[int, ShardWorker] = {}
        self.fr_fsms: dict[int, ShardFSM] = {}
        self.fr_pools: dict[str, _PoolRecord] = {}
        self.fr_runtime = FleetRuntime(self, {
            k: v for k, v in options.items() if k not in _ROUTER_OPTIONS})
        self.fr_samplers = self.fr_runtime.rt_samplers
        self.fr_submits: dict[int, int] = {}
        self.fr_collector = None
        self.fr_started = False

    # -- lifecycle --------------------------------------------------------

    def _make_worker(self, sid: int) -> ShardWorker:
        affinity = None
        if self.fr_affinity:
            affinity = self.fr_affinity[sid % len(self.fr_affinity)]
        if self.fr_backend == 'inline':
            return InlineWorker(sid, self.fr_loop, affinity)
        if self.fr_backend == 'thread':
            return ThreadWorker(sid, self.fr_loop, affinity)
        from .proc import ProcWorker
        return ProcWorker(sid, self.fr_loop, affinity)

    async def start(self, timeout_s: float = 15.0) -> None:
        if self.fr_started:
            raise CueBallError('FleetRouter already started')
        self.fr_loop = asyncio.get_running_loop()
        for sid in range(self.fr_nshards):
            worker = self._make_worker(sid)
            self.fr_workers[sid] = worker
            self.fr_fsms[sid] = ShardFSM(worker)
            self.fr_submits[sid] = 0
        for fsm in self.fr_fsms.values():
            fsm.start()
        for fsm in self.fr_fsms.values():
            await self._wait_state(fsm, ('running', 'failed'), timeout_s)
        failed = [sid for sid, f in self.fr_fsms.items()
                  if not f.is_in_state('running')]
        if failed:
            await self.stop()
            raise CueBallError('shards failed to start: %r' % (failed,))
        self.fr_started = True
        _ACTIVE_ROUTERS.append(self)

    async def stop(self, timeout_s: float = 15.0) -> None:
        # The shard samplers stop first, each on its own loop while it
        # still runs.
        await self.fr_runtime.stop()
        for fsm in self.fr_fsms.values():
            if fsm.get_state() == 'init':
                continue
            # 'starting' cannot take stopAsserted; let it settle first.
            await self._wait_state(
                fsm, ('running', 'failed', 'draining', 'stopped'),
                timeout_s)
            if fsm.get_state() in ('running', 'failed'):
                fsm.stop()
        for fsm in self.fr_fsms.values():
            if fsm.get_state() == 'init':
                continue
            await self._wait_state(fsm, ('stopped', 'failed'), timeout_s)
        self.fr_started = False
        if self in _ACTIVE_ROUTERS:
            _ACTIVE_ROUTERS.remove(self)
        if self.fr_collector is not None:
            self.detach_metrics()

    async def _wait_state(self, fsm, states, timeout_s: float) -> None:
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s
        while fsm.get_state() not in states:
            if loop.time() > deadline:
                raise CueBallError(
                    'timed out waiting for shard state %r (in %r)' % (
                        states, fsm.get_state()))
            await asyncio.sleep(0.005)

    async def restart_shard(self, shard_id: int,
                            timeout_s: float = 15.0) -> None:
        """Relaunch a failed shard and rebuild the pools it owned.
        The old pool objects lived on the dead loop; they are dropped
        (and unregistered from the monitor) and re-created from their
        recorded options/factory on the fresh loop."""
        fsm = self.fr_fsms[shard_id]
        if fsm.is_in_state('running'):
            return
        if not fsm.is_in_state('failed'):
            raise CueBallError(
                'can only restart a failed shard (in %r)'
                % fsm.get_state())
        owned = [r for r in self.fr_pools.values()
                 if r.shard_id == shard_id]
        from ..monitor import pool_monitor
        for rec in owned:
            if rec.pool is not None:
                try:
                    pool_monitor.unregister_pool(rec.pool)
                except Exception:
                    pass
                rec.pool = None
                rec.aux = None
        sampler = self.fr_samplers.pop(shard_id, None)
        if sampler is not None:
            sampler.stop()       # its loop is gone: stop it here
        fsm.start()
        await self._wait_state(fsm, ('running', 'failed'), timeout_s)
        if not fsm.is_in_state('running'):
            raise CueBallError('shard %d failed to restart' % shard_id)
        for rec in owned:
            await self._build_pool(rec)

    # -- pool management --------------------------------------------------

    @staticmethod
    def pool_key(name: str, options: dict | None = None) -> str:
        """Ring key: service name + stable hash of the options. Option
        values that aren't plain scalars (constructors, resolvers)
        contribute their type name only, so the key is reproducible
        across processes."""
        if not options:
            return name
        import hashlib
        parts = []
        for k in sorted(options):
            v = options[k]
            if isinstance(v, (str, int, float, bool, type(None))):
                parts.append('%s=%r' % (k, v))
            else:
                parts.append('%s=<%s>' % (k, type(v).__name__))
        digest = hashlib.blake2b('|'.join(parts).encode('utf-8'),
                                 digest_size=8).hexdigest()
        return '%s#%s' % (name, digest)

    def shard_of(self, name: str) -> int:
        rec = self.fr_pools.get(name)
        if rec is not None:
            return rec.shard_id
        return self.fr_ring.assign(name)

    def _construct(self, rec: _PoolRecord):
        # Runs inside the owning shard's loop.
        if rec.factory is not None:
            obj = rec.factory()
        else:
            from ..pool import ConnectionPool
            obj = ConnectionPool(dict(rec.options))
        aux = None
        if isinstance(obj, tuple):
            pool, aux = obj[0], obj[1:]
        else:
            pool = obj
        pool.p_shard = rec.shard_id
        return pool, aux

    async def _build_pool(self, rec: _PoolRecord) -> None:
        worker = self.fr_workers[rec.shard_id]
        if worker.backend == 'spawn':
            rec.aux = await worker.run(
                '%s:_construct_pool' % _PROC,
                rec.name, rec.factory, rec.shard_id)
        else:
            rec.pool, rec.aux = await worker.run(self._construct, rec)

    async def create_pool(self, name: str, options: dict | None = None,
                          factory=None) -> _PoolRecord:
        """Create a pool on the shard its key hashes to. Exactly one
        of ``options`` (a ConnectionPool options dict) or ``factory``
        (a zero-arg callable — or, for the spawn backend, a
        ``'module:function'`` spec — returning the pool or a tuple
        ``(pool, *aux)``) must be given."""
        if not self.fr_started:
            raise CueBallError('FleetRouter is not started')
        if name in self.fr_pools:
            raise CueBallError('pool %r already exists' % name)
        if (options is None) == (factory is None):
            raise ValueError('exactly one of options/factory required')
        key = self.pool_key(name, options)
        sid = self.fr_ring.assign(key)
        fsm = self.fr_fsms[sid]
        if not fsm.is_in_state('running'):
            raise ShardDeadError(sid, 'create_pool(%r)' % name)
        rec = _PoolRecord(name, key, sid, options, factory)
        self.fr_pools[name] = rec
        try:
            await self._build_pool(rec)
        except BaseException:
            self.fr_pools.pop(name, None)
            raise
        return rec

    async def destroy_pool(self, name: str,
                           timeout_s: float = 60.0) -> None:
        rec, worker, _fsm = self._lookup(name)

        async def stop_job(pool):
            pool.stop()
            loop = asyncio.get_running_loop()
            deadline = loop.time() + timeout_s
            while not pool.is_in_state('stopped'):
                if loop.time() > deadline:
                    raise CueBallError(
                        'pool %r did not stop in %.0fs' % (name,
                                                           timeout_s))
                await asyncio.sleep(0.05)

        if worker.backend == 'spawn':
            await worker.run('%s:_destroy_pool' % _PROC, name,
                             timeout_s)
        else:
            await worker.run(stop_job, rec.pool)
        self.fr_pools.pop(name, None)

    def get_pool(self, name: str):
        """The live pool object (None for spawn shards — the object
        lives in the child process)."""
        return self.fr_pools[name].pool

    def _lookup(self, name: str):
        rec = self.fr_pools.get(name)
        if rec is None:
            raise KeyError('no pool named %r' % name)
        fsm = self.fr_fsms[rec.shard_id]
        worker = self.fr_workers[rec.shard_id]
        if not fsm.is_in_state('running') or not worker.alive():
            raise ShardDeadError(rec.shard_id, 'pool %r' % name)
        return rec, worker, fsm

    # -- routed work ------------------------------------------------------

    def claim_cb(self, name: str, options=None, cb=None):
        """Route a callback-style claim to the owning shard. On the
        same loop (inline backend, or calls made from inside the
        shard) this is a direct ``pool.claim_cb`` call and returns the
        claim handle; cross-loop the claim is posted to the shard and
        ``cb`` is marshalled back to the calling loop (returns None)."""
        if callable(options) and cb is None:
            cb, options = options, {}
        rec, worker, _fsm = self._lookup(name)
        if worker.backend == 'spawn':
            raise CueBallError(
                'per-claim routing is not available on the spawn '
                'backend; submit a job instead')
        self.fr_submits[rec.shard_id] += 1
        caller_loop = asyncio.get_running_loop()
        if worker.loop is caller_loop:
            return rec.pool.claim_cb(options, cb)

        def cb_marshalled(*a):
            caller_loop.call_soon_threadsafe(cb, *a)
        worker.post(rec.pool.claim_cb, options, cb_marshalled)
        return None

    async def claim(self, name: str, options: dict | None = None):
        """Awaitable claim routed to the owning shard; returns a
        ``RoutedClaim`` whose ``release()``/``close()`` run on that
        shard's loop."""
        rec, worker, _fsm = self._lookup(name)
        if worker.backend == 'spawn':
            raise CueBallError(
                'per-claim routing is not available on the spawn '
                'backend; submit a job instead')
        self.fr_submits[rec.shard_id] += 1
        pool = rec.pool
        hdl, conn = await worker.run(pool.claim, options or {})
        return RoutedClaim(self, name, rec.shard_id, hdl, conn)

    async def claim_many(self, name: str, n: int,
                         options: dict | None = None):
        """Batched claim routed to the owning shard: one cross-loop
        hop claims the whole batch via ``pool.claim_many`` (the
        per-claim marshalling is what claim-per-call spends most of
        its budget on for thread shards). Returns a list of
        ``RoutedClaim``s; all-or-nothing like ``pool.claim_many``."""
        rec, worker, _fsm = self._lookup(name)
        if worker.backend == 'spawn':
            raise CueBallError(
                'per-claim routing is not available on the spawn '
                'backend; submit a job instead')
        self.fr_submits[rec.shard_id] += 1
        pool = rec.pool
        pairs = await worker.run(pool.claim_many, n, options or {})
        return [RoutedClaim(self, name, rec.shard_id, hdl, conn)
                for hdl, conn in pairs]

    async def release_many(self, claims) -> None:
        """Release a batch of RoutedClaims, one hop per owning shard
        (grouped) instead of one per claim."""
        by_shard: dict = {}
        for rc in claims:
            by_shard.setdefault((rc.rc_shard, rc.rc_name),
                                []).append(rc)
        for (_sid, name), group in by_shard.items():
            handles = [rc.handle for rc in group]

            def release_job(pool, hs=handles):
                pool.release_many(hs)
            await self.submit(name, release_job)

    async def submit(self, name: str, job, *args, **kwargs):
        """Run ``job(pool, *args, **kwargs)`` on the shard owning pool
        ``name`` and return its result. For the spawn backend ``job``
        must be a ``'module:function'`` spec; the child resolves it
        and passes its own pool object."""
        rec, worker, _fsm = self._lookup(name)
        self.fr_submits[rec.shard_id] += 1
        if worker.backend == 'spawn':
            return await worker.run('%s:_pool_job' % _PROC, name, job,
                                    args, kwargs)
        return await worker.run(job, rec.pool, *args, **kwargs)

    async def run_on(self, shard_id: int, job, *args, **kwargs):
        """Run a job on a specific shard regardless of pool routing
        (telemetry, benchmarks). Spawn jobs receive the child context
        dict as their first argument."""
        fsm = self.fr_fsms[shard_id]
        worker = self.fr_workers[shard_id]
        if not fsm.is_in_state('running') or not worker.alive():
            raise ShardDeadError(shard_id, 'run_on')
        self.fr_submits[shard_id] += 1
        return await worker.run(job, *args, **kwargs)

    # -- telemetry / merged surfaces --------------------------------------

    def shard_states(self) -> dict:
        return {sid: fsm.get_state()
                for sid, fsm in sorted(self.fr_fsms.items())}

    def snapshot(self) -> dict:
        pools = {}
        for name, rec in sorted(self.fr_pools.items()):
            pools[name] = {'shard': rec.shard_id, 'key': rec.key}
        snap = {
            'backend': self.fr_backend,
            'nshards': self.fr_nshards,
            'seed': self.fr_seed,
            'states': {str(k): v for k, v in self.shard_states().items()},
            'submits': {str(k): v
                        for k, v in sorted(self.fr_submits.items())},
            'pools': pools,
        }
        # Merged health verdicts, when any shard sampler runs the
        # health plane.
        health = self.fr_runtime.health_snapshot()
        if health is not None:
            snap['health'] = health
        return snap

    def attach_metrics(self, collector) -> None:
        """Publish per-shard gauges (shard-labelled) on ``collector``
        at scrape time via a collect hook."""
        if self.fr_collector is not None:
            raise CueBallError('metrics already attached')
        self.fr_collector = collector
        collector.add_collect_hook(self._publish_metrics)

    def detach_metrics(self) -> None:
        if self.fr_collector is None:
            return
        self.fr_collector.remove_collect_hook(self._publish_metrics)
        self.fr_collector = None

    def _publish_metrics(self) -> None:
        c = self.fr_collector
        if c is None:
            return
        up = c.gauge('cueball_shard_up',
                     'Shard event loop liveness (1 = running)')
        npools = c.gauge('cueball_shard_pools',
                         'Connection pools owned by the shard')
        nsub = c.gauge('cueball_shard_submits',
                       'Jobs/claims routed to the shard since start')
        # The runtime's pass counters. The cueball_shard_* gauges above
        # are the JAX router's own, line for line; these are the port's.
        job_ms = c.gauge('cueball_router_shard_job_ms',
                         'Milliseconds of the fleet pass jobs run on the '
                         'shard since start')
        hop_ms = c.gauge('cueball_router_shard_hop_ms',
                         'Milliseconds of the fleet pass jobs\' hops to '
                         'and from the shard since start')
        passes = c.gauge('cueball_router_passes',
                         'Fleet passes run over the shards since start, '
                         'by kind')
        rt = self.fr_runtime
        counts = {sid: 0 for sid in self.fr_fsms}
        for rec in self.fr_pools.values():
            counts[rec.shard_id] = counts.get(rec.shard_id, 0) + 1
        for sid, fsm in self.fr_fsms.items():
            labels = {'shard': str(sid)}
            up.set(1.0 if fsm.is_in_state('running') else 0.0, labels)
            npools.set(float(counts.get(sid, 0)), labels)
            nsub.set(float(self.fr_submits.get(sid, 0)), labels)
            job_ms.set(rt.rt_job_ms.get(sid, 0.0), labels)
            hop_ms.set(rt.rt_hop_ms.get(sid, 0.0), labels)
        for kind in ('sample', 'control', 'health'):
            passes.set(float(rt.rt_passes[kind]), {'kind': kind})

    async def control_fleet(self):
        """One control-plane pass: each running shard runs the fused
        control step over its own pools ON ITS OWN LOOP (via run_on)
        and applies the decision columns there; the per-shard summaries
        reduce shard->host. Not offered for the spawn backend (children
        run their own samplers)."""
        return await self.fr_runtime.control_fleet()

    async def health_fleet(self):
        """One health pass: each running shard ticks its HealthMonitor
        on its own loop, then the per-shard verdict records merge
        shard->host with :func:`parallel.health.reduce_health` (gray
        sets union, burn rates take the worst shard). Not offered for
        the spawn backend (children judge their own backends)."""
        return await self.fr_runtime.health_fleet()

    def _profile_shard(self, shard_id: int):
        # Runs inside the shard loop: fold the shard's completed claim
        # traces into one mergeable cost-attribution record. Thread
        # shards share the process trace ring, so the record filters by
        # the shard stamp the claim spans already carry.
        from .. import profile as mod_profile
        return mod_profile.profile_record(shard=shard_id)

    async def profile_fleet(self):
        """One profile pass: each running shard folds its phase
        ledgers into a cost-attribution record on its own loop, then
        the records merge shard->host with
        :func:`profile.reduce_profile` (totals sum, coverage re-derived
        wall-weighted) — the same reduction shape as
        :meth:`health_fleet`. Not offered for the spawn backend
        (children expose /kang/profile and /metrics; merge their
        scrapes with metrics.merge_expositions)."""
        if self.fr_backend == 'spawn':
            raise CueBallError(
                'profile_fleet is not available on the spawn backend; '
                'scrape the children and merge with merge_expositions')
        records = []
        for sid, fsm in sorted(self.fr_fsms.items()):
            if not fsm.is_in_state('running'):
                continue
            rec = await self.run_on(sid, self._profile_shard, sid)
            if rec:
                records.append(rec)
        from .. import profile as mod_profile
        return mod_profile.reduce_profile(records)

    def _wiretap_shard(self, shard_id: int):
        # Runs inside the shard loop: the loop-lag stats are loop-local
        # (the whole point of the column), so they must be read from
        # the shard's own loop; the transport ledger itself is
        # process-global and rides along once in the reduction.
        from .. import wiretap as mod_wiretap
        return mod_wiretap.wiretap_record(shard=shard_id)

    async def wiretap_fleet(self):
        """One wiretap pass: each running shard reports its loop-lag
        stats from its own loop, then the records merge shard->host
        with :func:`wiretap.reduce_wiretap` (lag folds worst-case —
        one saturated loop is the signal — and the process-global
        transport ledger rides along once). Mirrors
        :meth:`profile_fleet`; not offered for the spawn backend
        (children expose /kang/transport and /metrics; merge their
        scrapes with metrics.merge_expositions)."""
        if self.fr_backend == 'spawn':
            raise CueBallError(
                'wiretap_fleet is not available on the spawn backend; '
                'scrape the children and merge with merge_expositions')
        records = []
        for sid, fsm in sorted(self.fr_fsms.items()):
            if not fsm.is_in_state('running'):
                continue
            rec = await self.run_on(sid, self._wiretap_shard, sid)
            if rec:
                records.append(rec)
        from .. import wiretap as mod_wiretap
        return mod_wiretap.reduce_wiretap(records)

    async def sample_fleet(self, mesh=None, mesh_axes=('host', 'chip')):
        """One per-shard FleetSampler pass each on its own loop, then
        the shard->host reduction (and host->mesh when ``mesh`` is
        given). Not offered for the spawn backend."""
        return await self.fr_runtime.sample_fleet(mesh=mesh,
                                                  mesh_axes=mesh_axes)
