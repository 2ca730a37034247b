"""The port's side of a sharded router: :class:`FleetRuntime` runs the
fleet passes of ``cueball_tpu.shard.FleetRouter`` (sample, control,
health) with the port's samplers, one per shard, each on its shard's
loop."""

from .fleet import FleetRuntime

__all__ = ['FleetRuntime']
