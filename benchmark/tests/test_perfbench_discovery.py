"""A new configuration, traffic mix and metric, placed in a directory of
their own, are found by name and run with no edit to a file of the
harness."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import torch

from benchmark import spec
from benchmark.harness import run_cell

ROOT = Path(__file__).resolve().parents[2]


def test_new_files_are_found_and_run(tmp_path):
    home = tmp_path / 'benchmark'
    for sub in ('configs', 'workloads', 'metrics', 'limits'):
        (home / sub).mkdir(parents=True)
    cfg = json.loads((ROOT / 'benchmark/configs/fleet-65536.json')
                     .read_text())
    cfg.update(name='fleet-512', pools=512, capacity=512,
               reduced=['pools', 'capacity'])
    (home / 'configs/fleet-512.json').write_text(json.dumps(cfg))
    mix = json.loads((ROOT / 'benchmark/workloads/fleet-churn1.json')
                     .read_text())
    mix.update(churn_share=0.05, claims_per_tick=64, backends=16)
    (home / 'workloads/fleet-churn5.json').write_text(json.dumps(mix))
    (home / 'metrics/ticks_in_window.py').write_text(
        'def read(ctx):\n    return float(len(ctx.tick_s))\n')
    shutil.copy(ROOT / 'benchmark/metrics/setup_s.py',
                home / 'metrics/setup_s.py')
    shutil.copy(ROOT / 'benchmark/limits/fleet65k-churn1.json',
                home / 'limits/fleet512-churn5.json')
    bench = {
        'configs': [{'name': 'fleet-512', 'source': 'test',
                     'file': 'benchmark/configs/fleet-512.json',
                     'reduced': ['pools', 'capacity'], 'why': 'test'}],
        'workloads': [{'name': 'fleet512-churn5', 'config': 'fleet-512',
                       'traffic': 'fleet-churn5', 'chips': 1,
                       'why': 'test'}],
        'end_to_end': [{'name': 'ticks_in_window', 'unit': 'ticks',
                        'better': 'higher', 'bound': 0.1,
                        'source': 'host_clock'},
                       {'name': 'setup_s', 'unit': 's', 'better': 'lower',
                        'bound': 0.25, 'source': 'host_clock'}],
        'per_layer': []}
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))

    cell = spec.Cell('fleet512-churn5', tmp_path / 'BENCHMARK.json', home)
    assert cell.config['pools'] == 512
    assert cell.traffic['churn_share'] == 0.05
    assert [m['name'] for m in cell.metrics(False)] == ['ticks_in_window',
                                                        'setup_s']
    torch.set_num_threads(2)
    res = run_cell(cell, 77, 0.5, False, 'cpu', time.perf_counter())
    assert res['metrics']['ticks_in_window']['value'] == res['attempted']
    assert res['metrics']['setup_s']['unit'] == 's'
    assert res['readings']['input_mismatch'] == 0
    assert res['readings']['live_err'] < 1e-5


def test_every_listed_metric_has_a_reader_and_every_cell_its_files():
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    for m in bench['end_to_end'] + bench['per_layer']:
        assert callable(spec.load_reader(m['name'])), m['name']
    for w in bench['workloads']:
        cell = spec.Cell(w['name'])
        assert cell.limits, w['name']
        assert cell.traffic['kind'] == 'fleet_ticks'
        assert cell.metrics(False) and cell.metrics(True), w['name']
