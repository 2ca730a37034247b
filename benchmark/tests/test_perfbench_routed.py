"""The routed cell at a small size on the CPU: a sound run is correct,
its traced run reads both per-layer metrics, a program without the
router's ranges reads neither, and each fault of the routed path comes
out not correct."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import pytest
import torch

from benchmark import spec
from benchmark.compare import judge
from benchmark.harness import run_cell
from benchmark.reference import routed

CELL = 'routed65k-x4-churn1'
POOLS = 1024
TAPS = 8


def small_cell() -> spec.Cell:
    cell = spec.Cell(CELL)
    cfg = cell.config
    cfg['pools'] = POOLS
    cfg['capacity'] = int(np.bincount(routed.split(cfg)).max())
    cfg['taps'] = TAPS
    cell.traffic['warm_ticks'] = TAPS + 2
    return cell


def _run(trace: bool = False, seconds: float = 1.0) -> tuple:
    torch.set_num_threads(2)
    cell = small_cell()
    res = run_cell(cell, 2 ** 31 + 5, seconds, trace, 'cpu',
                   time.perf_counter())
    ok, rows = judge(res['readings'], cell.limits)
    return ok, dict((n, v) for n, v, _ in rows), res


def test_sound_run_is_correct():
    ok, rows, res = _run()
    assert ok, rows
    assert res['attempted'] > 0 and set(res['metrics']) == {'tick_ms',
                                                            'setup_s'}


def test_traced_run_reads_both_layers():
    ok, rows, res = _run(trace=True, seconds=2.0)
    assert ok, rows
    m = res['metrics']
    assert set(m) == {'router_hop_ms_per_pass', 'shard_job_ms_per_pass'}
    assert m['router_hop_ms_per_pass']['value'] > 0.0
    assert m['shard_job_ms_per_pass']['value'] > 0.0


def test_a_program_without_the_ranges_reads_no_layer(monkeypatch):
    from cueball_tpu_torch.shard import fleet

    monkeypatch.setattr(fleet, 'record_function',
                        lambda name: contextlib.nullcontext())
    ok, rows, res = _run(trace=True, seconds=2.0)
    assert ok, rows
    assert res['metrics'] == {}


@pytest.mark.parametrize('name', ['reduce_fleet', 'reduce_control',
                                  'reduce_health'])
def test_a_shard_left_out_of_a_reduction(name, monkeypatch):
    from cueball_tpu_torch.shard import fleet

    real = getattr(fleet, name)
    monkeypatch.setattr(fleet, name,
                        lambda records, **kw: real(records[:-1], **kw))
    ok, rows, _ = _run()
    assert not ok and rows['reduce_mismatch'] + rows['reduce_err'] > 0, rows


def test_a_pool_moved_to_another_shard(monkeypatch):
    """The first pool of the largest shard placed on the smallest, so no
    sampler outgrows its capacity."""
    from cueball_tpu_torch.shard import ring

    counts = np.bincount(routed.split(small_cell().config))
    owner = routed.split(small_cell().config)
    moved = routed.pool_name(int(np.nonzero(owner == counts.argmax())[0][0]))
    real = ring.HashRing.assign

    def assign(self, key):
        return int(counts.argmin()) if key == moved else real(self, key)
    monkeypatch.setattr(ring.HashRing, 'assign', assign)
    ok, rows, _ = _run()
    assert not ok and rows['shard_mismatch'] > 0, rows


def test_one_shards_decisions_dropped(monkeypatch):
    from cueball_tpu_torch.parallel import sampler

    real = sampler.apply_decisions

    def dropped(pools_by_row, decisions, at_ms=None, health=None):
        if any(getattr(p, 'p_shard', None) == 1
               for p in pools_by_row.values()):
            return {'applied': 0, 'rejected': 0, 'skipped': 0,
                    'epoch': int(np.asarray(decisions['epoch']))}
        return real(pools_by_row, decisions, at_ms=at_ms, health=health)
    monkeypatch.setattr(sampler, 'apply_decisions', dropped)
    ok, rows, _ = _run()
    assert not ok and rows['decision_mismatch'] > 0, rows
