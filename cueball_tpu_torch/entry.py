"""Entry points of the port: the fleet telemetry step and seeded inputs.

- :func:`entry` — (fleet_step, example_args) at 1024 pools.
- :func:`example_inputs` / :func:`tick_inputs` — seeded numpy draws in
  the same order as ``__graft_entry__`` does, so both packages
  can be fed identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .parallel.telemetry import fleet_init, fleet_inputs, fleet_step


def example_inputs(n_pools: int, taps: int = 128, seed: int = 0,
                   now_ms: float = 200.0, device=None):
    """(FleetState, FleetInputs) for ``n_pools`` active pools with
    seeded random loads, sojourns and retry positions."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    state = fleet_init(n_pools, taps=taps, device=dev)
    inp = fleet_inputs(
        n_pools, device=dev,
        samples=rng.uniform(0, 8, size=n_pools),
        sojourns=rng.uniform(0, 500, size=n_pools),
        target_delay=300.0,
        spares=2.0,
        maximum=16.0,
        retry_delay=100.0,
        retry_max_delay=10000.0,
        retry_attempt=rng.integers(0, 6, size=n_pools),
        n_retrying=rng.integers(0, 3, size=n_pools),
        active=True,
        now_ms=now_ms)
    return state, inp


def tick_inputs(base_inp, rng: np.random.Generator, k: int):
    """Fresh random per-tick signals on top of a base FleetInputs: new
    samples and sojourns, 5% reset rows, and the clock at 200 ms * (k+1)."""
    n = base_inp.samples.shape[0]
    dev = base_inp.samples.device
    f32 = torch.float32
    return base_inp._replace(
        samples=torch.as_tensor(rng.uniform(0, 8, size=n), dtype=f32,
                                device=dev),
        sojourns=torch.as_tensor(rng.uniform(0, 600, size=n), dtype=f32,
                                 device=dev),
        reset=torch.as_tensor(rng.uniform(size=n) < 0.05, device=dev),
        now_ms=torch.tensor(200.0 * (k + 1), dtype=f32, device=dev))


def entry(device=None):
    """(fn, example_args) for a single-device run of the telemetry step
    at 1024 pools."""
    return fleet_step, example_inputs(1024, device=device)
