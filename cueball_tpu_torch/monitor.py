"""The registry of live pools that the fleet sampler walks: the subset
of ``cueball_tpu.monitor.PoolMonitor`` it reads.

The sampler duck-types its monitor (``pm_pools``, ``pm_generation``),
so a ``cueball_tpu.monitor.PoolMonitor`` of the JAX package's pools
serves as well as this one.
"""

from __future__ import annotations


class PoolMonitor:
    def __init__(self):
        self.pm_pools: dict[str, object] = {}
        self.pm_fleet = None  # attached FleetSampler, if any
        # Bumped on every pool (un)registration so the FleetSampler can
        # skip its row-reconcile walk on ticks where the roster is
        # unchanged.
        self.pm_generation = 0

    def attach_fleet_sampler(self, sampler) -> None:
        """Publish a FleetSampler's snapshot through fleet_snapshot()."""
        self.pm_fleet = sampler

    def detach_fleet_sampler(self) -> None:
        self.pm_fleet = None

    def fleet_snapshot(self) -> dict:
        if self.pm_fleet is None:
            return {'attached': False}
        snap = self.pm_fleet.snapshot()
        snap['attached'] = True
        return snap

    def register_pool(self, pool) -> None:
        self.pm_pools[pool.p_uuid] = pool
        self.pm_generation += 1

    def unregister_pool(self, pool) -> None:
        if pool.p_uuid not in self.pm_pools:
            raise KeyError('pool %s is not registered' % pool.p_uuid)
        del self.pm_pools[pool.p_uuid]
        self.pm_generation += 1


# The process-wide registry a FleetSampler walks by default.
pool_monitor = PoolMonitor()
