"""The arithmetic of the metrics: percentiles over every sample, busy
time as a union, the roofline's bytes, the reading of a trace."""

from __future__ import annotations

import types

import numpy as np
import pytest

from benchmark import roofline, stats
from benchmark.spec import load_reader
from benchmark.tracing import TICK, TraceSummary


def test_percentiles_take_every_sample():
    rng = np.random.default_rng(3)
    xs = list(rng.exponential(10.0, 997))
    for q in (50.0, 95.0, 99.0):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    # One far sample more moves the tail: nothing is dropped.
    assert stats.percentile(xs + [1e6] * 60, 95.0) > stats.percentile(
        xs, 95.0)
    assert stats.percentile([], 95.0) is None


def test_tick_percentile_reads_every_tick():
    ticks = [0.010] * 900 + [0.050] * 100
    ctx = types.SimpleNamespace(tick_s=ticks)
    assert load_reader('tick_p95_ms')(ctx) == pytest.approx(50.0)
    assert load_reader('tick_ms')(ctx) == pytest.approx(14.0)


def test_union_of_intervals():
    assert stats.union([(0, 4), (2, 6), (8, 9), (9, 10)]) == [(0, 6),
                                                             (8, 10)]
    assert stats.length(stats.clip([(0, 6), (8, 10)], 5, 9)) == 2


def _trace():
    """Two ticks of 1000 us. Tick 1: a kernel 100-400 and a copy 300-500
    that overlaps it; tick 2: one kernel 1200-1300; a kernel outside
    any tick."""
    ev = [(TICK, 'tick', 0.0, 1000.0, 1), (TICK, 'tick', 1000.0, 2000.0, 1),
          ('aten::mul', 'cpu', 50.0, 150.0, 1),
          ('aten::empty', 'cpu', 60.0, 70.0, 1),       # nested in mul
          ('cudaMemcpyAsync', 'cpu', 600.0, 700.0, 1),
          ('aten::add', 'cpu', 1100.0, 1150.0, 1),
          ('aten::other_thread', 'cpu', 0.0, 2000.0, 2),
          ('k1', 'device', 100.0, 400.0, 0),
          ('copy', 'device', 300.0, 500.0, 0),
          ('k2', 'device', 1200.0, 1300.0, 0),
          ('late', 'device', 2500.0, 2600.0, 0)]
    return TraceSummary(ev, window_s=0.003)


def test_trace_busy_is_a_union_and_idle_its_rest():
    t = _trace()
    assert t.n_ticks == 2
    assert t.busy_in_ticks_s == pytest.approx(500e-6)    # 400 + 100, not 600
    assert t.busy_s == pytest.approx(600e-6)
    assert t.launches == 3
    assert t.torch_host_s == pytest.approx(250e-6)       # mul, memcpy, add
    ctx = types.SimpleNamespace(trace=t, device_kind='NVIDIA H100 80GB HBM3')
    assert load_reader('tick_device_idle_share')(ctx) == pytest.approx(75.0)
    assert load_reader('device_busy_ms_per_tick')(ctx) == pytest.approx(0.25)
    assert load_reader('launches_per_tick')(ctx) == pytest.approx(1.5)
    assert load_reader('sampler_python_ms_per_tick')(ctx) == pytest.approx(
        (2000e-6 - 250e-6) / 2 * 1e3)
    gaps = dict(t.idle_gaps)
    assert gaps['cudaMemcpyAsync'] == pytest.approx(100e-6)
    assert gaps['aten::mul'] == pytest.approx(50e-6)     # 50-100 of 0-100
    assert gaps['aten::add'] == pytest.approx(50e-6)
    assert sum(gaps.values()) == pytest.approx(1500e-6)


def test_readers_find_nothing_without_a_trace():
    ctx = types.SimpleNamespace(trace=None, device_kind='cpu')
    for name in ('tick_device_idle_share', 'device_busy_ms_per_tick',
                 'launches_per_tick', 'sampler_python_ms_per_tick',
                 'torch_host_ms_per_tick', 'tick_device_roofline'):
        assert load_reader(name)(ctx) is None, name


def test_roofline_bytes():
    assert roofline.ring_bytes(65536, 128) == 67_108_864     # 67.1 MB
    peak = roofline.PEAK_BYTES_PER_S['NVIDIA H100 80GB HBM3']
    fir_ms = roofline.fir_bytes(1 << 20, 128) / peak * 1e3
    assert fir_ms == pytest.approx(0.16151, abs=5e-6)
    tick = roofline.tick_bytes(65536, 128, 65)
    assert 67_108_864 < tick < 80e6
    assert tick / peak < 25e-6                # about 22 us at the peak


def test_roofline_share_of_a_tick():
    ctx = types.SimpleNamespace(
        trace=types.SimpleNamespace(n_ticks=10, busy_in_ticks_s=10 * 0.8e-3),
        device_kind='NVIDIA H100 80GB HBM3',
        config={'capacity': 65536, 'taps': 128, 'control': True,
                'health': True},
        traffic={'backends': 64})
    share = load_reader('tick_device_roofline')(ctx)
    need = roofline.tick_bytes(65536, 128, 65) / 3.35e12
    assert share == pytest.approx(100.0 * need / 0.8e-3)
    assert 2.0 < share < 4.0


def test_record_columns_read_through_the_row_mapping():
    """A record whose row view offers only the mapping interface reads
    as one that exposes its columns."""
    from benchmark.compare import record_columns
    from benchmark.tests.small import small_cell
    from benchmark.generators.fleet_ticks import FleetRun

    run = FleetRun(small_cell('fleet65k-churn1', pools=64), 3, 'cpu')
    try:
        for _ in range(3):
            rec, _ = run.tick()
    finally:
        run.close()
    cols, out = record_columns(rec)
    plain = dict(rec, pools=dict(rec['pools']))
    cols2, out2 = record_columns(plain)
    for k in cols2:
        np.testing.assert_array_equal(cols2[k], cols[k])
    for k in out2:
        np.testing.assert_array_equal(out2[k], out[k])
