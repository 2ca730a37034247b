"""Process-global pool monitor with kang-style snapshots.

Rebuild of reference `lib/pool-monitor.js`: a singleton registry of every
live pool/set/DNS-resolver in the process, exposing structural snapshots
(per-backend FSM state counts, dead lists, counters, next DNS wakeups)
for operator debugging. The reference serves these over Joyent's "kang"
debug protocol; here :meth:`PoolMonitor.to_kang_options` returns the same
shape, and :func:`serve_monitor` (in http_server.py) serves it as JSON
over HTTP (GET /kang/snapshot).
"""

from __future__ import annotations

from .transport import host_ident as _host_ident


class PoolMonitor:
    def __init__(self):
        self.pm_pools: dict[str, object] = {}
        self.pm_sets: dict[str, object] = {}
        self.pm_dns_res: dict[str, object] = {}
        self.pm_fleet = None  # attached FleetSampler, if any
        # Bumped on every pool (un)registration so the FleetSampler can
        # skip its row-reconcile walk on ticks where the fleet roster is
        # unchanged (the overwhelmingly common case).
        self.pm_generation = 0

    # -- fleet telemetry bridge ------------------------------------------

    def attach_fleet_sampler(self, sampler) -> None:
        """Publish a FleetSampler's batched decisions through the kang
        surface (snapshot()['fleet'] and GET /kang/fleet)."""
        self.pm_fleet = sampler

    attachFleetSampler = attach_fleet_sampler

    def detach_fleet_sampler(self) -> None:
        self.pm_fleet = None

    detachFleetSampler = detach_fleet_sampler

    def fleet_snapshot(self) -> dict:
        if self.pm_fleet is None:
            return {'attached': False}
        snap = self.pm_fleet.snapshot()
        snap['attached'] = True
        return snap

    # -- registration (reference lib/pool-monitor.js:27-58) --------------

    def register_pool(self, pool) -> None:
        self.pm_pools[pool.p_uuid] = pool
        self.pm_generation += 1

    registerPool = register_pool

    def unregister_pool(self, pool) -> None:
        assert pool.p_uuid in self.pm_pools
        del self.pm_pools[pool.p_uuid]
        self.pm_generation += 1

    unregisterPool = unregister_pool

    def register_set(self, cset) -> None:
        self.pm_sets[cset.cs_uuid] = cset

    registerSet = register_set

    def unregister_set(self, cset) -> None:
        assert cset.cs_uuid in self.pm_sets
        del self.pm_sets[cset.cs_uuid]

    unregisterSet = unregister_set

    def register_dns_resolver(self, res) -> None:
        self.pm_dns_res[res.r_uuid] = res

    registerDnsResolver = register_dns_resolver

    def unregister_dns_resolver(self, res) -> None:
        assert res.r_uuid in self.pm_dns_res
        del self.pm_dns_res[res.r_uuid]

    unregisterDnsResolver = unregister_dns_resolver

    # -- snapshots (reference lib/pool-monitor.js:60-216) -----------------

    def list_types(self) -> list[str]:
        return ['pool', 'set', 'dns_res']

    def list_objects(self, type_: str) -> list[str]:
        if type_ == 'pool':
            return list(self.pm_pools.keys())
        if type_ == 'set':
            return list(self.pm_sets.keys())
        if type_ == 'dns_res':
            return list(self.pm_dns_res.keys())
        raise ValueError('Invalid type "%s"' % type_)

    def get(self, type_: str, id_: str) -> dict:
        if type_ == 'pool':
            return self.get_pool(id_)
        if type_ == 'set':
            return self.get_set(id_)
        if type_ == 'dns_res':
            return self.get_dns_resolver(id_)
        raise ValueError('Invalid type "%s"' % type_)

    def get_pool(self, id_: str) -> dict:
        pool = self.pm_pools[id_]
        obj: dict = {}
        obj['backends'] = pool.p_backends
        obj['connections'] = {}
        ks = list(pool.p_keys)
        for k in pool.p_connections.keys():
            if k not in ks:
                ks.append(k)
        for k in ks:
            conns = pool.p_connections.get(k) or []
            counts: dict[str, int] = {}
            for fsm in conns:
                s = fsm.get_state()
                counts[s] = counts.get(s, 0) + 1
            obj['connections'][k] = counts
        obj['dead_backends'] = list(pool.p_dead.keys())
        if pool.p_last_rebalance is not None:
            obj['last_rebalance'] = round(pool.p_last_rebalance)
        obj['resolvers'] = getattr(pool.p_resolver, 'r_resolvers', None)
        obj['state'] = pool.get_state()
        shard = getattr(pool, 'p_shard', None)
        if shard is not None:
            # Stamped by a FleetRouter at pool construction; plain
            # (unsharded) pools keep their historical snapshot shape.
            obj['shard'] = shard
        obj['counters'] = pool.p_counters
        inner = getattr(pool.p_resolver, 'r_fsm', pool.p_resolver)
        obj['options'] = {
            'domain': getattr(inner, 'r_domain', None) or pool.p_domain,
            'service': getattr(inner, 'r_service', None),
            'defaultPort': getattr(inner, 'r_defport', None),
            'spares': pool.p_spares,
            'maximum': pool.p_max,
        }
        return obj

    getPool = get_pool

    def get_set(self, id_: str) -> dict:
        cset = self.pm_sets[id_]
        obj: dict = {}
        obj['backends'] = cset.cs_backends
        obj['fsms'] = {}
        obj['connections'] = list(cset.cs_connections.keys())
        ks = list(cset.cs_keys)
        for k in cset.cs_fsm.keys():
            if k not in ks:
                ks.append(k)
        for k in ks:
            fsm = cset.cs_fsm.get(k)
            if fsm is None:
                continue
            s = fsm.get_state()
            obj['fsms'][k] = {s: 1}
        obj['dead_backends'] = list(cset.cs_dead.keys())
        if cset.cs_last_rebalance is not None:
            obj['last_rebalance'] = round(cset.cs_last_rebalance)
        obj['resolvers'] = getattr(cset.cs_resolver, 'r_resolvers', None)
        obj['state'] = cset.get_state()
        obj['counters'] = cset.cs_counters
        obj['target'] = cset.cs_target
        obj['maximum'] = cset.cs_max
        inner = getattr(cset.cs_resolver, 'r_fsm', cset.cs_resolver)
        obj['options'] = {
            'domain': getattr(inner, 'r_domain', None) or cset.cs_domain,
            'service': getattr(inner, 'r_service', None),
            'defaultPort': getattr(inner, 'r_defport', None),
        }
        return obj

    getSet = get_set

    def get_dns_resolver(self, id_: str) -> dict:
        res = self.pm_dns_res[id_]
        obj: dict = {
            'domain': res.r_domain,
            'service': res.r_service,
            'resolvers': res.r_resolvers,
            'defaultPort': res.r_defport,
            'state': res.get_state(),
            'next': {},
            'backends': res.r_backends,
            'counters': res.r_counters,
        }
        if getattr(res, 'r_next_service', None):
            obj['next']['srv'] = _iso(res.r_next_service)
        if getattr(res, 'r_next_v6', None):
            obj['next']['v6'] = _iso(res.r_next_v6)
        if getattr(res, 'r_next_v4', None):
            obj['next']['v4'] = _iso(res.r_next_v4)
        return obj

    getDnsResolver = get_dns_resolver

    def to_kang_options(self) -> dict:
        return {
            'uri_base': '/kang',
            'service_name': 'cueball',
            'version': '1.0.0',
            'ident': _host_ident(),
            'list_types': self.list_types,
            'list_objects': self.list_objects,
            'get': self.get,
            'stats': lambda: {},
        }

    toKangOptions = to_kang_options

    def snapshot(self) -> dict:
        """Full JSON-able snapshot of every registered object (what the
        kang HTTP endpoint serves)."""
        out: dict = {'service_name': 'cueball',
                     'ident': _host_ident(),
                     'types': {}}
        for t in self.list_types():
            out['types'][t] = {
                id_: self.get(t, id_) for id_ in self.list_objects(t)}
        if self.pm_fleet is not None:
            out['fleet'] = self.fleet_snapshot()
        from . import trace as mod_trace
        routers = mod_trace._active_fleet_routers()
        if routers:
            # Started FleetRouters: backend, per-shard FSM states and
            # the pool -> shard ownership map, merged into the one
            # fleet-wide snapshot.
            out['shards'] = [r.snapshot() for r in routers]
        if mod_trace.tracing_enabled():
            # Ring occupancy + sampling counters (the spans themselves
            # are served raw by GET /kang/traces).
            out['traces'] = mod_trace.summary()
        run_meta = mod_trace.get_run_metadata()
        if run_meta:
            out['netsim_run'] = run_meta
        return out


def _iso(ts: float) -> str:
    import datetime
    return datetime.datetime.fromtimestamp(
        ts, datetime.timezone.utc).isoformat()


# Process-global singleton (reference lib/pool-monitor.js:9).
pool_monitor = PoolMonitor()
monitor = pool_monitor
