"""The frozen reference against the program's plain path at small sizes,
and the control (the reference one precision step lower) failing the
comparison."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.compare import judge
from benchmark.reference import steps
from benchmark.spec import Cell

from .small import run_small, small_cell

P, K, B = 512, 128, 96


def _inputs(rng, k):
    n = P
    return {
        'samples': rng.integers(0, 12, n).astype(np.float32),
        'sojourns': np.where(rng.random(n) < 0.3, rng.uniform(0, 900, n),
                             0.0).astype(np.float32),
        'target_delay': np.where(rng.random(n) < 0.4, 300.0,
                                 np.inf).astype(np.float32),
        'spares': np.full(n, 4.0, np.float32),
        'maximum': np.full(n, 10.0, np.float32),
        'retry_delay': np.full(n, 250.0, np.float32),
        'retry_max_delay': np.full(n, 1000.0, np.float32),
        'retry_attempt': rng.integers(0, 6, n).astype(np.float32),
        'n_retrying': rng.integers(0, 2, n).astype(np.float32),
        'active': rng.random(n) < 0.95,
        'reset': (rng.random(n) < 0.02) | (k == 0),
    }


def test_live_and_control_steps_match_the_program():
    from cueball_tpu_torch.parallel import control as pc
    from cueball_tpu_torch.parallel import telemetry as pt

    rng = np.random.default_rng(4)
    st_p = pt.fleet_init(P, K, device='cpu')
    cs_p = pc.control_init(P, device='cpu')
    st_r = steps.live_init(P, K)
    cs_r = steps.control_init(P)
    for k in range(150):
        cols = _inputs(rng, k)
        now = np.float32(200.0 * (k + 1))
        inp = pt.fleet_inputs(P, device='cpu', now_ms=now, **cols)
        st_p, out_p, fleet_p = pt.fleet_step_plain(st_p, inp)
        cs_p, dec_p, cfleet_p = pc.control_step(cs_p, pc.ControlInputs(
            samples=inp.samples, sojourns=inp.sojourns,
            filtered=out_p['filtered'], target_delay=inp.target_delay,
            spares=inp.spares, maximum=inp.maximum, active=inp.active,
            reset=inp.reset, now_ms=inp.now_ms))
        tin = {n: torch.as_tensor(cols[n]) for n in cols}
        st_r, out_r, fleet_r = steps.live_step(
            st_r, tin, torch.tensor(now))
        cs_r, dec_r, cfleet_r, epoch = steps.control_step(
            cs_r, tin, out_r['filtered'])
        torch.testing.assert_close(out_r['filtered'], out_p['filtered'],
                                   rtol=1e-6, atol=1e-6)
        for name in ('drop', 'retry_backoff'):
            assert torch.equal(out_r[name], out_p[name]), (k, name)
        for name in fleet_p:
            assert float(fleet_r[name]) == pytest.approx(
                float(fleet_p[name]), rel=1e-6, abs=1e-6), (k, name)
        assert torch.equal(dec_r['codel_target'], dec_p['codel_target'])
        assert int(dec_p['epoch']) == epoch
        for name in cfleet_p:
            assert cfleet_r[name] == pytest.approx(float(cfleet_p[name]),
                                                   rel=1e-6), (k, name)
    assert torch.equal(st_r.dropping, st_p.codel.dropping)


def test_health_step_matches_the_program():
    from cueball_tpu_torch.parallel import health as ph

    rng = np.random.default_rng(5)
    st_p = ph.health_init(B, device='cpu')
    st_r = steps.health_init(B)
    for k in range(30):
        lat = rng.uniform(1, 8, B).astype(np.float32)
        lat[7] *= 40.0
        cnt = rng.integers(0, 20, B).astype(np.int32)
        buckets = np.zeros((B, steps.LAT_BINS), np.int32)
        for b in range(B):
            buckets[b, steps.latency_bucket(float(lat[b]))] += cnt[b]
        cols = dict(lat_sum=(lat * cnt).astype(np.float32), lat_count=cnt,
                    lat_buckets=buckets, claim_buckets=buckets,
                    errors=rng.integers(0, 2, B).astype(np.int32),
                    shed=np.zeros(B, np.int32), active=np.ones(B, bool),
                    eligible=np.arange(B) > 0,
                    reset=np.full(B, k == 0))
        inp = ph.health_inputs(B, device='cpu', now_ms=np.float32(k),
                               **cols)
        st_p, ver_p, fleet_p = ph.health_step(st_p, inp)
        st_r, ver_r, fleet_r, epoch = steps.health_step(
            st_r, {n: torch.as_tensor(v) for n, v in cols.items()})
        assert torch.equal(ver_r['gray'], ver_p['gray']), k
        assert torch.equal(ver_r['score'], ver_p['score']), k
        torch.testing.assert_close(ver_r['ewma'], ver_p['ewma_ms'],
                                   rtol=1e-6, atol=0)
        for name, v in fleet_p.items():
            assert float(fleet_r[name]) == pytest.approx(
                float(v), rel=1e-6, abs=1e-9), (k, name)
    assert int(fleet_r['n_gray']) >= 1


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.3],
                     dtype=torch.float32)
    got = steps.tf32(x)
    assert got[0] == 1.0
    assert got[1] == 1.0                      # a tie rounds to even
    assert got[2] == 1.0 + 2 ** -9
    assert abs(float(got[3]) + 3.3) < 3.3 * 2 ** -11


def test_the_pools_take_decisions_and_the_reference_follows():
    """Past the warm-up every pool takes each tick's decision; a pool
    with a CoDel queue and a claim that waits for good tightens to the
    least target, and the reference's pools do the same."""
    from benchmark.generators.fleet_ticks import FleetRun

    run = FleetRun(small_cell('fleet65k-churn1', pools=64), 5, 'cpu')
    try:
        for _ in range(int(run.tr['warm_ticks']) + 3):
            rec, _ = run.tick()
            run.records.offer(run.ticks, rec)
        run.records.keep_last(run.ticks, rec)
    finally:
        run.close()
    assert run.pools[0].p_codel.cd_targdelay == 1.0     # CoDel, a waiter
    assert run.pools[3].p_codel.cd_targdelay == 300.0   # CoDel alone
    assert run.pools[1].p_ctrl_epoch == run.ticks
    assert run.pools[1].p_fleet_advisory is not None
    readings = run.check('cpu')
    assert readings['input_mismatch'] == 0, readings
    assert readings['decision_mismatch'] == 0, readings


@pytest.mark.parametrize('name', ['fleet65k-churn1', 'fleet65k-churn10'])
def test_the_control_fails_and_the_program_passes(name):
    """At a size a test run holds: the program's readings pass the
    cell's limits, and the lower-precision reference in its place
    fails them."""
    res = run_small(name, seconds=1.0, control=True, pools=512)
    limits = Cell(name).limits
    ok, rows = judge(res['readings'], limits)
    assert ok, rows
    ok, rows = judge(res['control'], limits)
    assert not ok, rows


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['fleet65k-churn1', 'fleet65k-churn10'])
def test_the_control_fails_at_the_cells_size_on_the_card(name, cuda_card):
    import time

    from benchmark.harness import run_cell

    cell = Cell(name)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        res = run_cell(cell, seed, 3.0, False, 'cuda', time.perf_counter(),
                       control=True)
        assert judge(res['readings'], cell.limits)[0], res['readings']
        assert not judge(res['control'], cell.limits)[0], res['control']
