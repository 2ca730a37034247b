"""Small cells on the CPU for the benchmark's own tests, built from the
real files with their sizes cut."""

from __future__ import annotations

import time

import torch

from benchmark import spec
from benchmark.harness import run_cell

#: Pools of a synthetic fleet in these tests (the cells run 65,536).
SMALL_POOLS = 256


def small_cell(name: str, pools: int = SMALL_POOLS) -> spec.Cell:
    cell = spec.Cell(name)
    if cell.config['kind'] == 'synthetic_fleet':
        cell.config['pools'] = cell.config['capacity'] = pools
    return cell


def run_small(name: str, seconds: float = 1.0, seed: int = 2 ** 31 + 7,
              control: bool = False, **kw) -> dict:
    torch.set_num_threads(2)
    return run_cell(small_cell(name, **kw), seed, seconds, False, 'cpu',
                    time.perf_counter(), control=control)
