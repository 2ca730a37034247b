"""Live fleet telemetry over a device mesh.

The FleetSampler normally steps every registered pool's control-law
signals on one device. With the ``mesh`` option the same live loop
runs split by rows over the mesh's devices: each shard steps its own
pools (one FIR kernel launch per shard on the card), and the fleet
aggregates (mean load, overload fraction, retry pressure) reduce over
the mesh, so one sampler spans more devices with no change in the
pools.

This demo registers the JAX package example's fleet (12 pools with
moving load, CoDel pressure on every third, a burst half-way through),
ticks a mesh-backed sampler beside a plain one for 40 ticks, and shows
(a) identical decisions from both and (b) the mesh shape on the
sampler's snapshot. The mesh is eight CPU shards with ``--device cpu``
(the JAX example's eight virtual devices) and four shards that share
the card otherwise. The clock is the sampler's host clock, frozen and
advanced 200 ms a tick by hand, so both samplers see the same instants.

    python -m cueball_tpu_torch.examples.fleet_mesh_sampler [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from .._device import resolve_device
from ..entry import frozen_host
from ..monitor import PoolMonitor
from ..parallel.mesh import Mesh
from ..parallel.sampler import FleetSampler

TICKS = 40


class DemoPool:
    """The minimal surface FleetSampler.gather_pool samples: stands in
    for a live ConnectionPool so the demo needs no sockets."""

    class _Codel:
        def __init__(self, target):
            self.cd_targdelay = target

    class _Waiter:
        def __init__(self, started):
            self.ch_started = started

        def is_in_state(self, st):
            return st == 'waiting'

    def __init__(self, seq: int, clock: list, codel_target=None):
        self.p_uuid = 'demo-%02d' % seq
        self.p_spares = 2
        self.p_max = 16
        self.p_codel = (self._Codel(codel_target)
                        if codel_target else None)
        self.p_waiters = []
        self.p_connections = {}
        self.load = 2.0
        self.clock = clock

    def lp_load_sample(self):
        return self.load

    def pressure(self, sojourn_ms):
        self.p_waiters = [self._Waiter(self.clock[0] - sojourn_ms)]


def main(device=None) -> dict:
    """Run the demo on ``device`` (default CUDA); prints the findings
    and returns them, with the mesh sampler's per-tick ``filtered`` and
    ``drop`` [TICKS, pools] (pools in name order) as numpy arrays."""
    dev = resolve_device(device)
    n_dev = 8 if dev.type == 'cpu' else 4
    mesh = Mesh([dev] * n_dev, ('pools',))

    clock = [1.0e6]
    host = frozen_host(clock)
    mon = PoolMonitor()
    fleet = [DemoPool(i + 1, clock, codel_target=300 if i % 3 == 0 else None)
             for i in range(12)]
    for p in fleet:
        mon.register_pool(p)

    meshed = FleetSampler({'monitor': mon, 'mesh': mesh, 'host': host})
    plain = FleetSampler({'monitor': mon, 'device': dev, 'host': host})

    names = sorted(p.p_uuid for p in fleet)
    filtered = np.zeros((TICKS, len(fleet)), np.float32)
    dropped = np.zeros((TICKS, len(fleet)), bool)
    rng = np.random.default_rng(7)
    agree = 0
    for t in range(TICKS):
        clock[0] += 200.0
        for i, p in enumerate(fleet):
            p.load = float(3.0 + 2.5 * np.sin(0.3 * t + i))
            if p.p_codel is not None:
                # The burst half-way through drives sojourns past the
                # 300 ms target: CoDel drop decisions go live.
                p.pressure(float(rng.uniform(400, 900)
                                 if 15 < t < 30 else
                                 rng.uniform(0, 150)))
        rec_m = meshed.sample_once()
        rec_p = plain.sample_once()
        same = all(
            abs(rec_m['pools'][u]['filtered'] -
                rec_p['pools'][u]['filtered']) < 1e-4 and
            rec_m['pools'][u]['drop'] == rec_p['pools'][u]['drop']
            for u in rec_m['pools'])
        agree += same
        filtered[t] = [rec_m['pools'][u]['filtered'] for u in names]
        dropped[t] = [rec_m['pools'][u]['drop'] for u in names]

    snap = meshed.snapshot()
    last = meshed.fs_latest['fleet']
    shards = len(meshed.fs_state)
    meshed.stop()
    plain.stop()
    print('%d pools sharded over %d devices (%s mesh on %s)' % (
        len(fleet), shards, snap['mesh']['shape'], dev))
    print('%d/%d ticks agree with the single-device sampler'
          % (agree, TICKS))
    print('codel dropped on %d pool-ticks' % int(dropped.sum()))
    print('fleet now: mean_load=%.2f overload_frac=%.2f '
          'max_sojourn=%.0fms' % (last['mean_load'],
                                  last['overload_frac'],
                                  last['max_sojourn']))
    if agree != TICKS or shards != n_dev:
        raise RuntimeError('the mesh sampler disagreed on %d ticks'
                           % (TICKS - agree))
    print('mesh sampler demo ok')
    return {'agree': agree, 'ticks': TICKS, 'shards': shards,
            'drops': int(dropped.sum()), 'filtered': filtered,
            'drop': dropped}


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default=None,
                        help='torch device (default: the CUDA card)')
    main(parser.parse_args().device)
