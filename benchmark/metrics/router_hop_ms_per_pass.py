"""router_hop_ms_per_pass: the traced passes' mean router pass range
(``cueball.router.pass``) less its shard jobs and its reduce range
(``cueball.router.reduce``): what the router's loop spends per pass
outside the shards' work, mostly the hops to and from the shard loops.
Worked out by the ``routed_passes`` generator; absent where the program
has no such ranges."""

from benchmark.generators import routed_passes


def read(ctx):
    if ctx.trace is None:
        return None
    return routed_passes.LAYER_READINGS.get('router_hop_ms_per_pass')
