"""Shard-per-core fleet scale-out: K event-loop shards behind a
consistent-hash claim router; this package's copy of the JAX package's
``shard``.

A :class:`FleetRouter` fronts K worker shards — each with its own
asyncio loop, runq pump and trace context — owning disjoint sets of
ConnectionPools assigned by a consistent-hash ring on the pool key.
Claims never cross a loop boundary on the hot path; cross-shard
traffic happens only at pool create/destroy and at telemetry/export
time. Its fleet passes run one port ``FleetSampler`` per shard through
a :class:`FleetRuntime`, on the card unless the router's ``device``
option says otherwise.
"""

from ..errors import ShardDeadError
from .fleet import FleetRuntime
from .ring import HashRing
from .router import FleetRouter, RoutedClaim, active_routers
from .worker import ShardFSM

__all__ = [
    'HashRing',
    'FleetRouter',
    'FleetRuntime',
    'RoutedClaim',
    'ShardFSM',
    'ShardDeadError',
    'active_routers',
]
