"""Entry points of the port: the fleet telemetry step and seeded inputs.

- :func:`entry` — (fleet_step, example_args) at 1024 pools.
- :func:`example_inputs` / :func:`tick_inputs` — seeded numpy draws in
  the same order as ``__graft_entry__`` does, so both packages
  can be fed identical inputs.
- :func:`dryrun_multichip` — every mesh form of the telemetry step
  held against the unsharded step over a :class:`Mesh` of n shards.
- :func:`health_example_columns` — health-step inputs like
  ``bench.py``'s health sweep.
- :class:`SyntheticPool` and :func:`frozen_host` — a fleet of pools and
  a hand-advanced clock for driving ``FleetSampler`` without live pools.
- :class:`SamplerWorkload` — such a fleet with CoDel queues, waiting
  claims, churning loads and attributed claims: the sampler workload
  ``chip_smoke.py`` checks and ``profile_live`` profiles.
- :class:`ShardedWorkload` — that workload split over the router's
  shard loop threads, with the router surface ``shard.FleetRuntime``
  drives.
"""

from __future__ import annotations

import asyncio
import types

import numpy as np
import torch

from . import host
from ._device import resolve_device
from .monitor import PoolMonitor
from .parallel.health import BUCKET_SCALE, LAT_BINS
from .parallel.mesh import Mesh, unshard
from .parallel.telemetry import (FleetInputs, _scan_shardings, fleet_init,
                                 fleet_inputs, fleet_scan, fleet_step,
                                 make_live_step, make_sharded_scan,
                                 make_sharded_step, make_shardmap_step,
                                 shard_inputs, shard_state, shard_window)
from .shard.worker import ShardFSM, ThreadWorker


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


def _state_leaves(state) -> list:
    return [state.windows, *state.codel, state.now_ms]


def dryrun_multichip(n_devices: int, device) -> list:
    """Hold every mesh form of the telemetry step against the unsharded
    ``fleet_step`` on identical seeded inputs, over a :class:`Mesh` of
    ``n_devices`` shards; the port of ``__graft_entry__``'s dryrun.

    ``device`` is the grid: a sequence of ``n_devices`` devices, or one
    device that every shard shares (``'cpu'``, or ``'cuda:0'`` for n
    shards on one card). The legs, each for 6 ticks at
    ``max(8, n) * 4`` pools with 5% reset rows: ``make_sharded_step``
    and ``make_shardmap_step`` on the 1-D ('pools',) mesh for seeds 0
    and 1; both again on a 2-D ('host', 'chip') mesh when ``n_devices``
    is even and at least 4; the live step (per-shard ping-pong) on the
    1-D and 2-D meshes; and ``make_sharded_scan`` on both. Every
    per-pool output, aggregate and state leaf is held to the unsharded
    run at rtol 1e-5 / atol 1e-5 (AssertionError otherwise). Returns
    the names of the legs run."""
    if isinstance(device, (str, torch.device)):
        devs = [device] * n_devices
    else:
        devs = list(device)
    if len(devs) != n_devices:
        raise ValueError('need %d devices, got %d' % (n_devices, len(devs)))
    mesh = Mesh(devs, ('pools',))
    ref_dev = mesh.first_device
    n_pools = max(8, n_devices) * 4   # tiny, divisible by the mesh
    ticks = 6
    legs = []

    def check(tag, got, want, seed, k):
        np.testing.assert_allclose(
            got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-5,
            err_msg='%s diverged from unsharded (seed %d, step %d)' % (
                tag, seed, k))

    def compare_on_mesh(kind, step, cmp_mesh, axes, seed):
        """K sharded steps against the unsharded laws: one comparison
        loop for every mesh shape and step form."""
        rng = np.random.default_rng(seed)
        state_ref, base = example_inputs(n_pools, seed=seed, device=ref_dev)
        state_sh = shard_state(state_ref, cmp_mesh, axes)
        for k in range(ticks):
            inp = tick_inputs(base, rng, k)
            state_ref, out_ref, fleet_ref = fleet_step(state_ref, inp)
            state_sh, out_sh, fleet_sh = step(
                state_sh, shard_inputs(inp, cmp_mesh, axes))
            out, fleet = unshard(out_sh), unshard(fleet_sh)
            for name in out_ref:
                check('%s per-pool %r' % (kind, name), out[name],
                      out_ref[name], seed, k)
            for name in fleet_ref:
                check('%s aggregate %r' % (kind, name), fleet[name],
                      fleet_ref[name], seed, k)
            for got, want in zip(_state_leaves(unshard(state_sh)),
                                 _state_leaves(state_ref)):
                check('%s FleetState' % kind, got, want, seed, k)
        legs.append(kind)

    mesh2 = axes2 = None
    if n_devices >= 4 and n_devices % 2 == 0:
        mesh2 = Mesh(np.array(devs, dtype=object).reshape(
            2, n_devices // 2), ('host', 'chip'))
        axes2 = ('host', 'chip')

    for kind, make in (('gspmd', make_sharded_step),
                       ('shard_map', make_shardmap_step)):
        for seed in (0, 1):
            compare_on_mesh(kind, make(mesh), mesh, ('pools',), seed)
    if mesh2 is not None:
        compare_on_mesh('gspmd-2d', make_sharded_step(mesh2, axes2),
                        mesh2, axes2, 7)
        compare_on_mesh('shard_map-2d', make_shardmap_step(mesh2, axes2),
                        mesh2, axes2, 7)

    # The live runtime's tick form: each shard ping-pongs its own ring.
    # Every carried state leaf is compared, so a shared or aliased
    # spare fails.
    compare_on_mesh('live', make_live_step(mesh, ('pools',)), mesh,
                    ('pools',), 11)
    if mesh2 is not None:
        compare_on_mesh('live-2d', make_live_step(mesh2, axes2), mesh2,
                        axes2, 13)

    # Sharded whole-window replay: each shard carries its rows through
    # the whole window.
    rng = np.random.default_rng(3)
    state0, base = example_inputs(n_pools, seed=3, device=ref_dev)
    window = FleetInputs(*(torch.stack(col) for col in zip(
        *(tick_inputs(base, rng, k) for k in range(ticks)))))
    fin_ref, outs_ref, fleets_ref = fleet_scan(state0, window)
    scan_meshes = [('scan', mesh, ('pools',))]
    if mesh2 is not None:
        scan_meshes.append(('scan-2d', mesh2, axes2))
    for tag, scan_mesh, axes in scan_meshes:
        fin_sh, outs_sh, fleets_sh = make_sharded_scan(scan_mesh, axes)(
            shard_state(state0, scan_mesh, axes),
            shard_window(window, scan_mesh, axes))
        _, _, (_, out_specs, fleet_specs) = _scan_shardings(axes)
        outs = unshard(outs_sh, out_specs)
        fleets = unshard(fleets_sh, fleet_specs)
        for name in outs_ref:
            check('%s per-pool %r' % (tag, name), outs[name],
                  outs_ref[name], 3, -1)
        for name in fleets_ref:
            check('%s aggregate %r' % (tag, name), fleets[name],
                  fleets_ref[name], 3, -1)
        for got, want in zip(_state_leaves(unshard(fin_sh)),
                             _state_leaves(fin_ref)):
            check('%s FleetState' % tag, got, want, 3, -1)
        legs.append(tag)
    return legs


def health_example_columns(n: int) -> dict:
    """Numpy columns for ``health_inputs`` over ``n`` backends, like
    ``bench.py``'s health sweep: latencies cycle 1-16 ms, an error on
    every 50th backend, ten claims per backend per tick; and every
    1000th backend is 64x slower, so the gray verdict is exercised.
    Row 0 (the unattributed bucket) is not eligible."""
    idx = np.arange(n)
    lat = (1.0 + idx % 16).astype(np.float32)
    lat[idx % 1000 == 0] *= 64.0
    bucket = np.minimum((np.log2(1.0 + lat) * BUCKET_SCALE).astype(np.int32),
                        LAT_BINS - 1)
    buckets = np.zeros((n, LAT_BINS), np.int32)
    buckets[idx, bucket] = 10
    return dict(lat_sum=lat * 10.0, lat_count=np.full(n, 10, np.int32),
                lat_buckets=buckets, claim_buckets=buckets,
                errors=(idx % 50 == 0).astype(np.int32),
                active=np.ones(n, bool), eligible=idx > 0)


class _Codel:
    def __init__(self, target):
        self.cd_targdelay = target


class _Waiter:
    def __init__(self, started):
        self.ch_started = started

    def is_in_state(self, state):
        return state == 'waiting'


class SyntheticPool:
    """A pool as FleetSampler reads it (the surface of bench.py's
    ``_BenchPool``: a load sample, spares 2, maximum 16, no slot in
    backoff), speaking the push protocol: :meth:`set_load` marks its
    rows dirty. ``codel_target`` (ms) gives it a CoDel queue;
    ``waiting_since`` (ms on the sampler's clock) puts a claim at the
    head of that queue."""

    def __init__(self, i: int, codel_target: float | None = None,
                 waiting_since: float | None = None):
        self.p_uuid = 'synthetic-%d' % i
        self.p_spares = 2
        self.p_max = 16
        self.p_codel = None if codel_target is None else _Codel(codel_target)
        self.p_waiters = (() if waiting_since is None
                          else (_Waiter(waiting_since),))
        self.p_connections = {}
        self.load = float(i % 8)
        self.handles = ()

    def lp_load_sample(self):
        return self.load

    def telemetry_attach(self, handle):
        self.handles = self.handles + (handle,)

    def telemetry_detach(self, handle):
        self.handles = tuple(h for h in self.handles if h is not handle)

    def set_load(self, v: float):
        self.load = v
        for h in self.handles:
            h.mark_dirty()


def frozen_host(clock: list, base=host):
    """A host seam (the port's own by default, or ``base``, as from
    ``host.seam_over``) with its clock read from ``clock[0]`` (ms),
    which the caller advances by hand: two samplers given it see the
    same instant."""
    names = ('_Interval', 'backend_index', 'backend_key_for',
             'add_backend_sink', 'remove_backend_sink', 'backend_sinks',
             'active_collector', 'loop_lag_p99_us', 'drain_native')
    return types.SimpleNamespace(
        **{name: getattr(base, name) for name in names},
        current_millis=lambda: clock[0])


class SamplerWorkload:
    """``n_pools`` synthetic pools on one :class:`PoolMonitor` and one
    frozen clock, for samplers with control and health on. Every third
    pool has a 300 ms CoDel target and every fifth a claim waiting since
    up to 0.7 s, so that CoDel drops. :meth:`advance` moves one tick:
    the clock by 200 ms, a new load on 1% of the pools, and 512 claims
    attributed over ``n_backends`` backends (``backend-7`` 40x slower,
    2% failing), offered to every registered backend sink as a claim
    tracer would. A sampler's health table joins the sinks on its first
    tick, so it sees the claims of later ticks."""

    def __init__(self, n_pools: int, n_backends: int = 64, seed: int = 9):
        self.clock = [1.0e6]
        self.monitor = PoolMonitor()
        self.pools = [SyntheticPool(
            i, codel_target=300.0 if i % 3 == 0 else None,
            waiting_since=(self.clock[0] - float(i % 700) if i % 5 == 0
                           else None))
            for i in range(n_pools)]
        for p in self.pools:
            self.monitor.register_pool(p)
        self.keys = ['backend-%d' % b for b in range(n_backends)]
        self.rng = np.random.default_rng(seed)

    def options(self, **extra) -> dict:
        """FleetSampler options over this workload, control and health
        on; ``extra`` adds to them (``device='cpu'``)."""
        return dict({'monitor': self.monitor, 'control': True,
                     'health': True, 'host': frozen_host(self.clock)},
                    **extra)

    def advance(self) -> None:
        rng, n = self.rng, len(self.pools)
        self.clock[0] += 200.0
        for i in rng.choice(n, n // 100, replace=False):
            self.pools[i].set_load(float(rng.integers(0, 12)))
        for b in rng.integers(0, len(self.keys), 512):
            ms = float(rng.uniform(1, 8)) * (40.0 if b == 7 else 1.0)
            ok = bool(rng.random() < 0.98)
            for sink in host.backend_sinks():
                sink.observe(self.keys[b], ms if ok else None, ms + 1.0, ok)


class ShardedWorkload(SamplerWorkload):
    """A :class:`SamplerWorkload` of ``n_shards * pools_per_shard``
    pools split over ``n_shards`` shard loop threads, each a
    ``shard.worker.ThreadWorker`` with its ``ShardFSM``: the pieces of
    a thread-backed ``shard.FleetRouter``. Pool ``i`` is stamped
    ``p_shard = i // pools_per_shard``, as the router stamps the pools a
    shard owns.

    It has the router surface ``shard.FleetRuntime`` reads:
    ``fr_backend`` ('thread'), ``fr_fsms[sid].is_in_state('running')``,
    ``fr_workers[sid].run(job, *args)`` and ``run_on(sid, job, *args)``,
    each awaitable from any loop. It routes no claims and has no hash
    ring: it is a workload, not a router. The shards start when it is
    built and stop in :meth:`close`, both on a loop of the workload's
    own that takes the workers' signals and the FSMs' timers, so build
    and close it outside a running loop. :meth:`advance` is
    ``SamplerWorkload.advance`` (call it between passes)."""

    fr_backend = 'thread'

    def __init__(self, n_shards: int, pools_per_shard: int,
                 n_backends: int = 64, seed: int = 9):
        super().__init__(n_shards * pools_per_shard, n_backends, seed)
        for i, pool in enumerate(self.pools):
            pool.p_shard = i // pools_per_shard
        self._loop = asyncio.new_event_loop()
        self.fr_workers = {sid: ThreadWorker(sid, self._loop)
                           for sid in range(n_shards)}
        self.fr_fsms = {sid: ShardFSM(worker)
                        for sid, worker in self.fr_workers.items()}
        self._loop.run_until_complete(self._settle(ShardFSM.start,
                                                   'running'))

    async def _settle(self, assert_, state: str) -> None:
        """``assert_(fsm)`` on every shard's FSM, then wait until each
        is in ``state`` or has failed (each state's own timeout bounds
        the wait); a failed shard raises."""
        for fsm in self.fr_fsms.values():
            assert_(fsm)
        while not all(fsm.get_state() in (state, 'failed')
                      for fsm in self.fr_fsms.values()):
            await asyncio.sleep(0.005)
        failed = [sid for sid, fsm in self.fr_fsms.items()
                  if not fsm.is_in_state(state)]
        if failed:
            raise RuntimeError('shards %r did not reach %r'
                               % (failed, state))

    async def run_on(self, shard_id: int, job, *args):
        if not self.fr_fsms[shard_id].is_in_state('running'):
            raise RuntimeError('shard %d is not running' % shard_id)
        return await self.fr_workers[shard_id].run(job, *args)

    def close(self) -> None:
        """Stop every shard's loop thread; a second call does nothing."""
        if self._loop.is_closed():
            return
        try:
            self._loop.run_until_complete(self._settle(ShardFSM.stop,
                                                       'stopped'))
        finally:
            self._loop.close()
