"""Where a cell's parts live. Everything is found by the names
``BENCHMARK.json`` gives, so a new cell, configuration, traffic mix or
metric is a new file and no edit:

- a cell: an entry of ``workloads`` in ``BENCHMARK.json``;
- its configuration: the entry of ``configs`` it names, whose ``file``
  holds the sizes it runs;
- its traffic mix: ``benchmark/workloads/<traffic>.json``, read by the
  generator that its ``kind`` names;
- its limits: ``benchmark/limits/<cell>.json``, one per number
  compared;
- each metric: ``benchmark/metrics/<metric>.py``, whose ``read(ctx)``
  returns the value or None.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell:
    """One cell of a benchmark file, with its configuration, traffic
    mix, limits and metric lists loaded."""

    def __init__(self, name: str, bench_file: Path | None = None,
                 home: Path = HERE):
        bench_file = bench_file or ROOT / 'BENCHMARK.json'
        bench = json.loads(bench_file.read_text())
        cells = {w['name']: w for w in bench['workloads']}
        if name not in cells:
            raise KeyError('no workload %r in %s' % (name, bench_file))
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry['chips'])
        configs = {c['name']: c for c in bench['configs']}
        self.config_entry = configs[self.entry['config']]
        # A ``file`` is relative to the checkout that holds ``home``.
        self.config = json.loads(
            (home.parent / self.config_entry['file']).read_text())
        self.traffic = json.loads(
            (home / 'workloads' / (self.entry['traffic'] + '.json'))
            .read_text())
        limits = home / 'limits' / (name + '.json')
        self.limits = (json.loads(limits.read_text())['limits']
                       if limits.exists() else {})
        self.home = home

        def mine(metric):
            return name in metric.get('workloads', (name,))
        self.end_to_end = [m for m in bench['end_to_end'] if mine(m)]
        self.per_layer = [m for m in bench['per_layer'] if mine(m)]

    def metrics(self, trace: bool) -> list:
        return self.per_layer if trace else self.end_to_end


def load_reader(name: str, home: Path = HERE):
    """The ``read`` function of ``<home>/metrics/<name>.py``."""
    path = home / 'metrics' / (name + '.py')
    spec = importlib.util.spec_from_file_location(
        'benchmark_metric_' + name.replace('.', '_').replace('-', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(cell: Cell, ctx, trace: bool) -> dict:
    """{name: {'value', 'unit'}} for the cell's metrics of this mode;
    a metric whose reader finds nothing to read is left out."""
    out = {}
    for m in cell.metrics(trace):
        value = load_reader(m['name'], cell.home)(ctx)
        if value is not None:
            out[m['name']] = {'value': value, 'unit': m['unit']}
    return out
