"""The port's routed fleet against the benchmark's plain reference, on
the CPU.

A ``FleetRouter`` of 4 thread shards owns 1,024 of the benchmark's
synthetic pools, each created with ``router.create_pool`` under its
ring name, and runs 10 passes of the routed cell's cycle (sample,
sample, sample, control, health) on a frozen clock, with the cell's
churn and claims, through the benchmark's ``routed_passes`` generator.
Every shard's live, control and health records and every pass's
reduced record are held against ``benchmark/reference/routed.py``
under the cell's own limits; the FIR runs 4 taps, so that decisions
reach the pools from the fourth pass. The reference's ring places every
pool where the router did. The router's ranges and counters
(``shard/fleet.py``) are checked on the same run.
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from benchmark import spec  # noqa: E402
from benchmark.compare import judge  # noqa: E402
from benchmark.generators.routed_passes import RoutedRun  # noqa: E402
from benchmark.reference import routed  # noqa: E402
from cueball_tpu_torch.metrics import Collector  # noqa: E402
from cueball_tpu_torch.shard.fleet import (JOB_RANGE, PASS_RANGE,  # noqa: E402
                                           REDUCE_RANGE)

CELL = 'routed65k-x4-churn1'
POOLS = 1024
PASSES = 10
TAPS = 4


@pytest.fixture(scope='module')
def run():
    torch.set_num_threads(2)
    cell = spec.Cell(CELL)
    cfg = cell.config
    cfg['pools'] = POOLS
    cfg['capacity'] = int(np.bincount(routed.split(cfg)).max())
    cfg['taps'] = TAPS
    cell.traffic['checked_ticks'] = PASSES
    r = RoutedRun(cell, 2 ** 31 + 11, 'cpu')
    r.records_seen = []
    try:
        for _ in range(PASSES):
            rec, _dt = r.run_pass()
            r.records.offer(r.passes, rec)
            r.records_seen.append(rec)
        r.records.keep_last(r.passes, rec)
        yield cell, r
    finally:
        r.close()


def test_every_pass_matches_the_reference(run):
    cell, r = run
    readings = r.check('cpu')
    ok, rows = judge(readings, cell.limits)
    assert ok, rows
    assert readings['missing_ticks'] == 0
    assert r.records.wanted == PASSES
    # Decisions reached the pools: their control records took them.
    applied = [rec['reduced']['applied'] for rec in r.records_seen
               if rec['kind'] == 'control']
    assert applied[-1] > 0


def test_reference_ring_places_each_pool_where_the_router_did(run):
    cell, r = run
    owner = routed.split(cell.config)
    placed = {name: rec.shard_id for name, rec in r.router.fr_pools.items()}
    assert placed == {routed.pool_name(i): int(s)
                      for i, s in enumerate(owner)}
    assert set(owner.tolist()) == {0, 1, 2, 3}
    for sid, sampler in r.router.fr_samplers.items():
        assert sampler.fs_capacity == cell.config['capacity']
        assert len(sampler.fs_rows) == int(np.sum(owner == sid))


def test_passes_and_shard_times_are_counted(run):
    _cell, r = run
    rt = r.router.fr_runtime
    kinds = collections.Counter(rec['kind'] for rec in r.records_seen)
    assert dict(rt.rt_passes) == dict(kinds)
    assert set(kinds) == {'sample', 'control', 'health'}
    assert sorted(rt.rt_job_ms) == sorted(rt.rt_hop_ms) == [0, 1, 2, 3]
    assert all(v > 0.0 for v in rt.rt_job_ms.values())
    assert all(v > 0.0 for v in rt.rt_hop_ms.values())
    coll = Collector()
    r.router.attach_metrics(coll)
    try:
        text = coll.collect()
    finally:
        r.router.detach_metrics()
    for kind, n in kinds.items():
        assert 'cueball_router_passes{kind="%s"} %d' % (kind, n) in text
    for sid in range(4):
        assert 'cueball_router_shard_job_ms{shard="%d"}' % sid in text
        assert 'cueball_router_shard_hop_ms{shard="%d"}' % sid in text


def test_a_pass_opens_its_ranges(run, monkeypatch):
    """One pass opens its pass and reduce ranges on the router's thread
    and a job range on each shard's, each a ``record_function``."""
    import contextlib
    import threading

    from cueball_tpu_torch.shard import fleet

    _cell, r = run
    threads = collections.defaultdict(set)
    real = fleet.record_function

    @contextlib.contextmanager
    def recorded(name):
        threads[name].add(threading.get_ident())
        with real(name):
            yield
    monkeypatch.setattr(fleet, 'record_function', recorded)
    rec, _dt = r.run_pass()
    r.records_seen.append(rec)
    assert threads[PASS_RANGE] == threads[REDUCE_RANGE] == {
        threading.get_ident()}
    shard_threads = {w._thread.ident for w in r.router.fr_workers.values()}
    assert threads[JOB_RANGE] == shard_threads and len(shard_threads) == 4
