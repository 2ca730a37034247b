"""shard_job_ms_per_pass: the traced passes' mean sum of their shard
jobs' milliseconds, each job timed on its shard's loop inside its
``cueball.router.shard_job`` range (the router's per-shard job
counters): the shards' sampler ticks. Worked out by the
``routed_passes`` generator; absent where the program does not count
them."""

from benchmark.generators import routed_passes


def read(ctx):
    if ctx.trace is None:
        return None
    return routed_passes.LAYER_READINGS.get('shard_job_ms_per_pass')
