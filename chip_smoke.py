#!/usr/bin/env python3
"""Drive the PyTorch port (``cueball_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

0. device: the card's name, and its name and power limit from nvidia-smi;
1. build: every CUDA kernel of the port, from ``cueball_tpu_torch/csrc``,
   with nvcc for sm_90a;
2. kernel: the FIR kernel against its plain PyTorch version on the card,
   at several pool counts and two tap counts;
3. entry: ``entry()`` at 1024 pools, the kernel step against the
   plain-FIR step on every output, aggregate and state leaf;
4. live: the main path, the live step at 1,048,576 pools for 50 seeded
   ticks with 5% reset rows, checked tick by tick against a plain-FIR
   run; the kernel's launch count over these ticks must be 50;
5. scan: ``fleet_scan`` over 64 ticks at 65,536 pools equals stepping;
6. timing: the kernel, its plain version and ``torch.mv`` (the one
   PyTorch call computing the same function) beside the card's bound;
7. control: beside phase 4's 50 ticks, the control step on each tick's
   FleetInputs and ``filtered`` output at 1,048,576 pools, held bit for
   bit (decisions, epoch, carried targets) against the control step on
   the CPU on copies of the same tensors, ``mean_load`` to rtol 1e-5;
8. health: the health step at 102,400 backends for 10 ticks (latencies
   cycling 1-16 ms, every 50th backend erring, every 1000th 64x slow),
   against the CPU: verdicts exactly off the score's rounding boundary,
   the fleet's counts exactly (those that read the score within what
   the backends on its boundary can move), floats to rtol 1e-5, and
   some backend judged gray;
9. sampler: the main path through its real entry point, two
   ``FleetSampler``s with control and health on over one
   ``entry.SamplerWorkload`` (one pool monitor of 65,536 duck-typed
   pools, one frozen clock, attributed claims), one on the card and
   one on the CPU, for 20 ticks with 1% of pools changing load each
   tick; their records agree, CoDel drops occur, and the FIR kernel
   launches once per tick;
10. multichip dryrun: ``entry.dryrun_multichip`` over four shards that
    share the card (a 1-D mesh and a 2x2 mesh), every mesh form of the
    telemetry step against the unsharded step;
11. sharded live (main path): on phase 4's seeded inputs, 50 ticks at
    1,048,576 pools of the live step over a 4-shard mesh on the card
    (4 x 262,144 rows) and of the shard_map step over a 2x2 mesh,
    each against the unsharded kernel step: per-pool outputs and
    state bit for bit, ``n_pools`` exactly, float aggregates to rtol
    1e-5 / atol 1e-5, and the FIR kernel launched 4 times per tick;
    the sharded control step at 1,048,576 pools and the sharded health
    step at 102,400 backends bit for bit against their unsharded runs
    on the card;
12. mesh sampler (main path): phase 9's workload, one ``FleetSampler``
    over the 4-shard mesh and one without a mesh, both on the card,
    for 20 ticks: records equal (the float fleet aggregates, summed in
    another order, to rtol 1e-5 / atol 1e-5), 4 FIR launches per tick;
13. router fleet passes (main path): ``shard.FleetRuntime`` over an
    ``entry.ShardedWorkload`` of 4 shard loop threads x 16,384 pools
    (phase 9's 65,536 pools, 64 backends, control and health on), on
    the card, from an empty kernel build directory: first the four
    shard loops launch the kernel at once and race to build it (one
    nvcc runs, each launch matches the plain FIR), then 20
    ``sample_fleet`` passes (every other one reduced over a 2x2 mesh on
    the card and held to the flat reduce of the same rows), 20
    ``control_fleet`` and 10 ``health_fleet``, ``advance()`` between
    passes; every pass's row and every shard's tick record held against
    a twin workload run through ``FleetRuntime(device='cpu')``, and the
    FIR kernel launched exactly 4 times per pass;
14. surfaces: the loop-lag sampler armed on each shard loop (samples on
    each, and the fleet row's ``loop_lag_p99_us`` > 0 on the next
    pass); ``http_server.serve_monitor`` fetched from a thread:
    ``/kang/health`` equals ``health_snapshot()`` with ``backend-7``
    gray, ``?limit=1`` keeps one monitor row, ``?bogus=1`` is a 400,
    ``POST`` a 405, an unknown path a 404, ``/kang/fleet`` shows the
    attached shard sampler; ``debug.install_debug_handler`` over a
    recording handler and two SIGUSR2s: both handlers run each time, the
    first turns the port's stack capture and profiler on and the second
    off, and the dump holds the ``gray backend-7`` line;
15. examples: both examples' ``main(device='cuda')`` in-process, with
    their FIR launches counted (one per replayed tick; one per shard
    and one plain per mesh-sampler tick), then each held against its
    ``main(device='cpu')`` (the plain FIR) on the same seeded inputs:
    the replay's [T, P] drops exactly, ``target`` and ``clamped``
    exactly off their rounding boundary, every float output and fleet
    aggregate to rtol 1e-5 / atol 1e-5; the mesh demo's per-tick drops
    exactly and ``filtered`` to the same tolerance. Then the
    ``ConnectionSet`` example's ``MuxClient`` over a ``DNSResolver``
    that finds its three servers in SRV records of a UDP nameserver
    in-process: 60 calls over all three, one server leaves the SRV set
    and is killed once the resolver has removed it, 30 calls over the
    other two; and ``cbresolve`` in DNS mode (the 8 SRV targets of a
    service, with their keys) and in static mode;
16. bench (main path): every stage of ``cueball_tpu_torch.bench`` at
    full size (the live step at 1,048,576 pools, the sweeps at
    ``CONTROL_SIZES`` and ``HEALTH_SIZES``, sampler ticks over 1024,
    10240 and 102400 pools), through ``bench.run_stages`` on the card:
    every stage lands with finite, positive rates, the stage record is
    printed, and the FIR kernel launched in ``step_live``,
    ``step_kernel``, ``scan`` and each tick stage and never in
    ``step_plain``. Then, at every fleet size the stages stepped
    (``bench.step_pools()``: 8, 1024, 10240, 65536, 102400 and
    1,048,576 pools, on the bench's own inputs and on them with every
    window filled with seeded loads), ``fleet_step_cuda`` and one live
    tick are held against ``fleet_step_plain`` as in phase 3; these
    launches are not counted as the bench's;
17. inference fleet (main path): the script
    ``examples_torch/inference_fleet_client.py`` for 50 requests over
    two HTTP servers it serves in-process, in a process of its own where
    ``cueball_tpu``, ``jax`` and ``jaxlib`` are unimportable (its pools
    are the port's own), its port sampler on the card and a twin on the
    CPU fed the same rows at the same instants: every request served,
    the fleet aggregates of every tick within rtol 1e-5 / atol 1e-5 of
    the twin's, one FIR launch per tick;
18. non-finite inputs: the card's raw ``.to(torch.int32)`` of NaN, +-inf,
    +-4e9 and 2.5 printed, and ``to_int32_xla`` (XLA's saturating cast,
    which the control and health steps use) equal on the card and the
    CPU over its edges and 10,000 seeded values; the fixed non-finite
    rows (five control cases in one 16-pool tick, two health
    ``lat_sum`` columns over 8 backends) bit-identical on the card to
    the CPU port, to the JAX package's numbers frozen here and to the
    4-shard step; then 4 chained ticks of the control step at 1,048,576
    pools and of the health step at 102,400 backends with 1% of each
    float column replaced by NaN, +-inf, -5, +-4e9, 0 or 1e-30: held
    against the CPU port as in phases 7 and 8 (NaN equal to NaN), and
    the 4-shard steps bit for bit against the unsharded ones; last,
    the launches and device busy time per control and health step, as
    ``profile_live`` counts them, beside phases 7 and 8's times and the
    nvidia-smi line;
19. pool fleet (main path): ``cueball_tpu_torch.examples.pool_fleet``:
    64 of the port's ``ConnectionPool``s over 8 HTTP servers served
    in-process, each with a ``StaticIpResolver`` over 4 of them, spares
    2, maximum 4, both fleet actuations on, the claim tracer feeding
    the health table; 2,000 claim / GET / release cycles at a
    concurrency of 32 while one ``FleetSampler`` on the card (control
    and health on, 32 taps) ticks every 20 claims, and a CPU twin over
    shadows of the same pools ticks at the same instants: every claim
    served, every tick's record held against the twin's as in phase 9
    (inputs exactly, the fleet aggregates to rtol 1e-5 / atol 1e-5),
    one FIR launch per tick, and the card sampler's advisories and
    decisions (with its epoch) found on the pools; ``ulimit -n`` checked
    against the sockets the phase opens. Then the same fleet without
    the twin for its claims per second and ms per tick;
20. discovered fleet (main path):
    ``cueball_tpu_torch.examples.discovered_fleet``: phase 19's fleet
    with its backends discovered in DNS. A UDP nameserver in-process
    answers from the port's ``netsim.dns.SimZone``; 64 services, each
    an SRV set of 8 targets (servers 0-7) with A records, TTLs 1 s; one
    ``ConnectionPool`` per service built from its ``domain``,
    ``service`` and ``resolvers`` (the port's ``DNSResolver`` over its
    DNS client and a real socket). 2,000 claims at a concurrency of 32,
    the card sampler and its CPU twin ticking every 20 claims as in
    phase 19; at claim 1,000 the zone replaces target 0 by target 8
    (server 8) in every SRV set and the run waits, at most 10 s, until
    every pool's resolver has emitted ``removed`` for it and ``added``
    for the new one. Then 50 requests of the port's ``HttpAgent`` by
    hostname over the same nameserver. Every claim and request served,
    every tick held against the twin as in phase 19, one FIR launch per
    tick; after the swap no pool holds a connection to server 0,
    server 8 served requests, every pool's monitor record lists the new
    SRV set, and the card sampler's health table has a row for the new
    backend. Then the same fleet without the twin for its claims per
    second and ms per tick;
21. sharded fleet (main path): ``cueball_tpu_torch.examples.sharded_fleet``:
    phase 19's 64 pools made through ``router.create_pool`` on the port's
    own ``shard.FleetRouter`` with 4 thread shard loops (each pool on the
    shard its ring assigns); 2,000 claim / GET / release cycles through
    ``router.claim`` at a concurrency of 32, a ``sample_fleet`` pass every
    20 claims and a ``control_fleet`` and a ``health_fleet`` pass every
    100, each tick of a shard's card sampler preceded, in the same job on
    its loop, by a CPU twin's over shadows of that shard's pools; the
    profiler's SIGPROF sampler armed and a ``LoopAffinityChecker``
    installed across the claims. Every claim served; every pool's
    ``p_shard`` its ring shard; every pass's per-shard records held
    against the twins' as in phase 19 and its reduced row against the
    same reduction of the twins'; 4 FIR launches per pass; control
    decisions found on the pools; ``profile_fleet`` and
    ``wiretap_fleet`` merge 4 shards; profiler samples > 0 and the
    flamegraph starting ``claim;``; ``GET /kang/shards`` equal to
    ``router.snapshot()`` and ``GET /kang/profile`` non-empty; the FSM
    dump listing the router, one line per shard and one per pool; no
    loop-affinity violation; ``ulimit -n`` checked. Then the same fleet
    without the twin for claims per second, ms per sample pass and FIR
    launches per pass.

Then one ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1
and prints no result.
"""

import asyncio
import contextlib
import io
import json
import logging
import os
import resource
import shutil
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from cueball_tpu_torch import (bench, cli, convert, debug, host,
                               http_server, profile, profile_live, utils)
from cueball_tpu_torch._cast import to_int32_xla
from cueball_tpu_torch._device import to_host_values
from cueball_tpu_torch.entry import (SamplerWorkload, ShardedWorkload,
                                     dryrun_multichip, entry,
                                     example_inputs,
                                     health_example_columns, tick_inputs)
from cueball_tpu_torch.dns_resolver import DNSResolver
from cueball_tpu_torch.examples import (discovered_fleet, fleet_mesh_sampler,
                                        inference_fleet_client,
                                        multiplexed_set_client, pool_fleet,
                                        sharded_fleet, telemetry_replay)
from cueball_tpu_torch.kernels import build
from cueball_tpu_torch.ops import fir
from cueball_tpu_torch.parallel import control as ctl
from cueball_tpu_torch.parallel import health as hl
from cueball_tpu_torch.parallel import telemetry as tel
from cueball_tpu_torch.parallel.mesh import (Mesh, tree_map,
                                             tree_map_with_path, unshard)
from cueball_tpu_torch.parallel.sampler import FleetSampler, reduce_fleet
from cueball_tpu_torch.shard import FleetRuntime

RTOL = ATOL = 1e-5          # the tolerance of the multichip dryrun
ENTRY_POOLS = 1024
LIVE_POOLS = 1 << 20
LIVE_TICKS = 50
SCAN_POOLS, SCAN_TICKS = 1 << 16, 64
KERNEL_POOLS = (1, 255, 256, 300, 1 << 16, 1 << 20)
KERNEL_TAPS = (128, 97)
TIMING_POOLS = (ENTRY_POOLS, LIVE_POOLS)
TAPS = 128
HEALTH_BACKENDS, HEALTH_TICKS = 102_400, 10
SAMPLER_POOLS, SAMPLER_TICKS = 1 << 16, 20
SAMPLER_BACKENDS = 64
SHARDS = 4                  # mesh shards, all on the one card
# Router passes: 4 shard loops x 16,384 pools = phase 9's 65,536.
ROUTER_POOLS = SAMPLER_POOLS // SHARDS
ROUTER_PASSES = (('sample', 20), ('control', 20), ('health', 10))
# Bench stages that must launch the FIR kernel (step_plain must not).
BENCH_KERNEL_STAGES = ('step_live', 'step_kernel', 'scan') + tuple(
    'tick_cost_%d' % n for n in bench.TELEM_TICK_SIZES)
FLEET_REQUESTS = 50
#: Sockets phase 19 may hold beyond its pools' (client and server side
#: of every connection): the process's own files, the card's, the
#: servers' listeners.
FD_HEADROOM = 256
#: Phase 15's ConnectionSet over DNS: the SRV name of its servers, and
#: the calls before and after one of them leaves the SRV set.
MUX_SERVICE, MUX_DOMAIN = '_mux._tcp', 'mux.test'
MUX_CALLS = (60, 30)
#: Ports phase 15's zone names for cbresolve's lookup (nothing listens).
CBRESOLVE_PORTS = [8000 + j for j in range(discovered_fleet.SERVERS)]
FLEET_SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            'examples_torch', 'inference_fleet_client.py')
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# Phase 18: non-finite and out-of-range inputs. The JAX package casts
# float to int32 with XLA's saturating convert; these rows are where a
# cast that does not saturate shows. The CPU tests hold every frozen
# number below against the JAX package itself.
NAN, INF = float('nan'), float('inf')
#: What phase 18 prints the card's raw ``.to(torch.int32)`` of.
RAW_CAST_PROBE = (NAN, INF, -INF, 4e9, -4e9, 2.5)
#: The cast's edges: the probe, both int32 bounds as floats, the float32
#: values next to them, halves, a signed zero and the float32 extremes.
CAST_EDGES = RAW_CAST_PROBE + (-2.5, 2.0 ** 31, -2.0 ** 31, 2147483520.0,
                               -2147483904.0, 0.5, -0.5, -0.0, 3e38, -3e38)
#: What a fuzzed float column's specials are drawn from.
SPECIALS = (NAN, INF, -INF, -5.0, 4e9, -4e9, 0.0, 1e-30)
SPECIAL_SHARE = 0.01
NONFINITE_TICKS = 4
PROFILED_STEPS = 10
#: One control tick from ``control_init(16)`` at ``now_ms`` 100, every
#: row active: case k sets row k's columns, the other rows are ordinary
#: (rows 8-15 over their CoDel target).
NONFINITE_POOLS = 16
NONFINITE_CONTROL_CASES = (
    ('spares_4e9_maximum_inf', {'spares': 4e9, 'maximum': INF}),
    ('samples_nan', {'samples': NAN}),
    ('samples_inf', {'samples': INF}),
    ('spares_nan', {'spares': NAN}),
    ('maximum_nan', {'maximum': NAN}),
)
#: ``cueball_tpu.parallel.control.control_step``'s decisions on all five
#: cases in one fleet.
JAX_NONFINITE_DECISIONS = {
    'codel_target': [300.0] * 8 + [262.0] * 8,
    'plan_spares': [2147483647, 2, 2, 0, 0] + [2] * 3 + [3] * 8,
    'plan_target': [2147483647, 0, 16, 0, 0] + [5] * 11,
    'delta': [0, 0, -2147483631, 0, -5] + [0] * 11,
    'epoch': 1,
}
#: One health tick from ``health_init(8)``, one claim per backend, every
#: row active and eligible, over each of two ``lat_sum`` columns: a mean
#: below -1 ms makes ``log2(1 + ewma)`` NaN, and so do NaN and +inf.
NONFINITE_BACKENDS = 8
NONFINITE_LAT_SUMS = (
    ('mean_below_minus_one', (10.0, -5.0, 30.0, 7.0, 5.0, 5.0, 5.0, 5.0)),
    ('nan_and_inf', (10.0, NAN, 30.0, INF, 5.0, 5.0, 5.0, 5.0)),
)
#: ``cueball_tpu.parallel.health.health_step``'s score column for each
#: ``lat_sum`` column, and its fleet row's counts for both.
JAX_NONFINITE_SCORES = {
    'mean_below_minus_one': [55, 0, 79, 48, 41, 41, 41, 41],
    'nan_and_inf': [55, 0, 79, 255, 41, 41, 41, 41],
}
JAX_NONFINITE_HEALTH_FLEET = {'n_backends': 7, 'median_score': 41,
                              'mad_score': 0, 'n_gray': 0}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name):
    print('== %s' % name, flush=True)


def max_errs(got, want):
    """(max abs error, max rel error) of got against want, on the card."""
    diff = (got - want).abs()
    rel = diff / want.abs().clamp_min(1e-30)
    return float(diff.max()), float(rel.max())


def compare_step(tag, got, want):
    """Hold one step's (state, outputs, aggregates) against another's:
    floats to RTOL/ATOL, `drop` and the carried state exactly (`target`
    and `clamped` are check_target's). Returns the two `filtered`
    outputs."""
    (gs, go, gf), (ws, wo, wf) = got, want
    for name in ('filtered', 'retry_backoff'):
        torch.testing.assert_close(go[name], wo[name], rtol=RTOL, atol=ATOL,
                                   msg=lambda m: '%s %s: %s' % (tag, name, m))
    check(torch.equal(go['drop'], wo['drop']), '%s: drop differs' % tag)
    for name in wf:
        torch.testing.assert_close(gf[name], wf[name], rtol=RTOL, atol=ATOL,
                                   msg=lambda m: '%s %s: %s' % (tag, name, m))
    check(torch.equal(gs.windows, ws.windows), '%s: windows differ' % tag)
    for name in gs.codel._fields:
        check(torch.equal(getattr(gs.codel, name), getattr(ws.codel, name)),
              '%s: codel.%s differs' % (tag, name))
    check(torch.equal(gs.now_ms, ws.now_ms), '%s: now_ms differs' % tag)
    return go['filtered'], wo['filtered']


def check_target(tag, got_out, want_out, inp):
    """`target` and `clamped` equal on every row off their rounding
    boundary; returns the number of rows on it."""
    edge = convert.target_near_boundary(
        want_out['filtered'].cpu().numpy(), inp.samples.cpu().numpy(),
        inp.spares.cpu().numpy())
    off = torch.as_tensor(~edge, device=got_out['target'].device)
    for name in ('target', 'clamped'):
        check(torch.equal(got_out[name][off], want_out[name][off]),
              '%s: %s differs off the rounding boundary' % (tag, name))
    return int(edge.sum())


def time_ms(fn, iters):
    """Mean device time of fn() over iters launches, by CUDA events,
    after a warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fir_bound_ms(p, k):
    """Least time for the FIR on this card: windows, taps read once and
    the output written once over HBM bandwidth, against 2*P*K f32
    flops over the f32 peak. Returns (ms, 'bytes' or 'operations')."""
    byte_ms = 4.0 * (p * k + k + p) / HBM_BYTES_PER_S * 1e3
    op_ms = 2.0 * p * k / F32_FLOPS * 1e3
    return (byte_ms, 'bytes') if byte_ms >= op_ms else (op_ms, 'operations')


def cpu_copy(tree):
    """A NamedTuple of tensors, each copied to the CPU."""
    return type(tree)(*(t.cpu() for t in tree))


def cast_vector(seed=0):
    """CAST_EDGES, then 10,000 seeded normal values times 1e9, as
    float32."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        np.asarray(CAST_EDGES, np.float32),
        (rng.standard_normal(10_000) * 1e9).astype(np.float32)])


def with_specials(rng, col, share):
    """A float32 copy of ``col`` with ``share`` of its rows, drawn by
    ``rng``, replaced by values drawn from SPECIALS."""
    out = np.array(col, np.float32)
    rows = rng.random(out.shape[0]) < share
    out[rows] = rng.choice(np.asarray(SPECIALS, np.float32), int(rows.sum()))
    return out


def nonfinite_control_columns(cases):
    """Numpy columns of one control tick over NONFINITE_POOLS pools,
    with the k-th dict of ``cases`` setting row k's columns."""
    n = NONFINITE_POOLS
    cols = dict(samples=np.full(n, 3.0, np.float32),
                sojourns=np.repeat(np.float32([100.0, 400.0]), n // 2),
                filtered=np.full(n, 3.0, np.float32),
                target_delay=np.full(n, 300.0, np.float32),
                spares=np.full(n, 2.0, np.float32),
                maximum=np.full(n, 16.0, np.float32),
                active=np.ones(n, bool), reset=np.zeros(n, bool),
                now_ms=np.float32(100.0))
    for row, overrides in enumerate(cases):
        for name, v in overrides.items():
            cols[name][row] = v
    return cols


def nonfinite_health_columns(lat_sum):
    """Numpy columns of one health tick over NONFINITE_BACKENDS
    backends that each served one claim, ``lat_sum`` ms in all."""
    n = NONFINITE_BACKENDS
    return dict(lat_sum=np.asarray(lat_sum, np.float32),
                lat_count=np.ones(n, np.int32), active=np.ones(n, bool),
                eligible=np.ones(n, bool), now_ms=np.float32(1000.0))


def same(got, want):
    """Equal dtype, shape and values; with ``equal_nan`` semantics for
    floats (NaN where the other holds NaN)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if not got.dtype.is_floating_point:
        return torch.equal(got, want)
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan], want[~nan]))


def check_control(tag, got, want, equal_nan=False):
    """Hold one control step's (state, decisions, fleet) against the
    CPU run's: every decision and the carried state bit for bit,
    `mean_load` to rtol 1e-5. With ``equal_nan``, NaN in a float column
    equals NaN in the same row."""
    (gs, gd, gf), (ws, wd, wf) = got, want
    eq = same if equal_nan else torch.equal
    for name in wd:
        check(eq(gd[name].cpu(), wd[name]), '%s: %s differs' % (tag, name))
    check(eq(gs.targets.cpu(), ws.targets), '%s: targets' % tag)
    for name in ('n_pools', 'pressure', 'max_sojourn'):
        check(eq(gf[name].cpu(), wf[name]), '%s: %s' % (tag, name))
    torch.testing.assert_close(gf['mean_load'].cpu(), wf['mean_load'],
                               rtol=RTOL, atol=0, equal_nan=equal_nan)


def check_health(tag, got, want, equal_nan=False):
    """Hold one health step against the CPU run's: `gray` and `score`
    exactly off the score boundary; the fleet's counts that do not read
    `score` exactly; median, MAD and `n_gray` exactly when no backend is
    on the boundary, else within how far that many +-1 flips of `score`
    can move them; floats to rtol 1e-5 (with ``equal_nan``, NaN equals
    NaN in the same row). Returns the number of backends on the
    boundary."""
    (_, gv, gf), (_, wv, wf) = got, want
    edge = convert.health_score_near_boundary(wv['ewma_ms'].numpy())
    off = torch.as_tensor(~edge)
    for name in ('gray', 'score'):
        check(torch.equal(gv[name].cpu()[off], wv[name][off]),
              '%s: %s differs off the score boundary' % (tag, name))
    check(torch.equal(gv['epoch'].cpu(), wv['epoch']), '%s: epoch' % tag)
    for name in ('ewma_ms', 'z'):
        torch.testing.assert_close(gv[name].cpu(), wv[name], rtol=RTOL,
                                   atol=ATOL, equal_nan=equal_nan)
    n_edge = int(edge.sum())
    # median_score, mad_score, n_gray: the median moves by at most one,
    # each deviation by that plus its own flip, each flip one verdict.
    slack = dict(zip(('median_score', 'mad_score', 'n_gray'),
                     (1, 2, n_edge) if n_edge else (0, 0, 0)))
    for name, want_v in wf.items():
        got_v = gf[name].cpu()
        if want_v.dtype.is_floating_point:
            torch.testing.assert_close(got_v, want_v, rtol=RTOL, atol=ATOL,
                                       equal_nan=equal_nan)
        elif name in slack:
            check(got_v.dtype == want_v.dtype and
                  abs(int(got_v) - int(want_v)) <= slack[name],
                  '%s: %s %d vs %d with %d backends on the score boundary'
                  % (tag, name, int(got_v), int(want_v), n_edge))
        else:
            check(torch.equal(got_v, want_v), '%s: %s' % (tag, name))
    return n_edge


def check_sampler_records(tag, got, want, counts=True):
    """Hold the card sampler's tick record against the CPU sampler's, as
    the tests do: inputs equal, floats to RTOL/ATOL, `drop` exactly,
    `target`, `clamped` and the plans exactly off the target boundary,
    the health record's verdicts exactly. Without ``counts``, the
    control record's applied, rejected and skipped counts are not held
    (a twin over shadow pools applies nothing). Returns (rows on the
    target boundary, drops this tick)."""
    gp, wp = got['pools'], want['pools']
    check(gp.tp_rows == wp.tp_rows, '%s: rows differ' % tag)
    for name, col in wp.tp_cols.items():
        check(np.array_equal(gp.tp_cols[name], col),
              '%s: input %s differs' % (tag, name))
    go, wo = gp.tp_out, wp.tp_out
    for name in ('filtered', 'retry_backoff'):
        np.testing.assert_allclose(go[name], wo[name], rtol=RTOL, atol=ATOL,
                                   err_msg='%s %s' % (tag, name))
    check(np.array_equal(go['drop'], wo['drop']), '%s: drop' % tag)
    off = ~convert.target_near_boundary(
        wo['filtered'], wp.tp_cols['samples'], wp.tp_cols['spares'])
    for name in ('target', 'clamped'):
        check(np.array_equal(go[name][off], wo[name][off]),
              '%s: %s differs off the boundary' % (tag, name))
    for name, v in want['fleet'].items():
        check(abs(got['fleet'][name] - v) <= ATOL + RTOL * abs(v),
              '%s: fleet %s %r vs %r' % (tag, name, got['fleet'][name], v))
    check([plane in got for plane in ('control', 'health')] ==
          [plane in want for plane in ('control', 'health')],
          '%s: the records run different planes' % tag)
    if 'control' in want:
        check_control_record(tag, got['control'], want['control'], off,
                             counts)
    if 'health' in want:
        check_health_record(tag, got['health'], want['health'])
    return int((~off).sum()), int(wo['drop'].sum())


def check_control_record(tag, gc, wc, off, counts=True):
    """A tick's control record against the twin's (see
    check_sampler_records); ``off`` masks the rows off the target
    boundary."""
    names = ('applied', 'rejected', 'skipped') if counts else ()
    for name in names + ('epoch', 'step_ms'):
        check(gc[name] == wc[name], '%s: control %s' % (tag, name))
    for name, v in wc['decisions'].items():
        mask = off if v.ndim and name != 'codel_target' else ...
        check(np.array_equal(gc['decisions'][name][mask], v[mask]),
              '%s: decision %s differs' % (tag, name))
    for name, v in wc['fleet'].items():
        check(abs(gc['fleet'][name] - v) <= RTOL * abs(v),
              '%s: control %s' % (tag, name))


def check_health_record(tag, gh, wh):
    """A health verdict record against the twin's: verdicts exactly,
    the fleet's numbers to RTOL/ATOL."""
    check((gh['epoch'], gh['gray']) == (wh['epoch'], wh['gray']),
          '%s: health verdicts differ' % tag)
    check(sorted(gh['backends']) == sorted(wh['backends']),
          '%s: health backends differ' % tag)
    for key, wb in wh['backends'].items():
        gb = gh['backends'][key]
        check((gb['gray'], gb['score']) == (wb['gray'], wb['score']),
              '%s: backend %s verdict differs' % (tag, key))
    for name, v in wh['fleet'].items():
        g = gh['fleet'][name]
        check(type(g) is type(v) and abs(g - v) <= ATOL + RTOL * abs(v),
              '%s: health %s %r vs %r' % (tag, name, g, v))


def leaves(tree):
    """(path, tensor) for every leaf of a tree of tensors."""
    out = []
    tree_map_with_path(lambda p, x: out.append(('/'.join(map(str, p)), x)),
                       tree)
    return out


def check_same(tag, got, want, equal_nan=False):
    """Two trees of tensors equal leaf by leaf, dtype and bits; with
    ``equal_nan``, NaN equals NaN in the same place."""
    for (path, g), (_, w) in zip(leaves(got), leaves(want)):
        ok = same(g, w) if equal_nan else (g.dtype == w.dtype
                                           and torch.equal(g, w))
        check(ok, '%s: %s differs' % (tag, path))


def check_sharded(tag, got, want):
    """A sharded step's (states, outs, aggregates) against the
    unsharded step's: state and per-pool outputs bit for bit,
    `n_pools` exactly, the float aggregates to RTOL/ATOL."""
    gs, go, gf = (unshard(t) for t in got)
    ws, wo, wf = want
    check_same(tag + ' state', gs, ws)
    check_same(tag + ' per-pool', go, wo)
    check(torch.equal(gf['n_pools'], wf['n_pools']),
          '%s: n_pools differs' % tag)
    for name in wf:
        torch.testing.assert_close(gf[name], wf[name], rtol=RTOL, atol=ATOL,
                                   msg=lambda m: '%s %s: %s' % (tag, name, m))


def clone(tree):
    return tree_map(torch.clone, tree)


def mesh_phases(dev, start, end):
    """Phases 10-12. Returns their numbers for the summary lines."""
    grid = [torch.device('cuda', 0)] * SHARDS
    mesh = Mesh(grid, ('pools',))
    mesh2 = Mesh(np.array(grid, dtype=object).reshape(2, 2),
                 ('host', 'chip'))
    axes2 = ('host', 'chip')

    phase('10 multichip dryrun')
    legs = dryrun_multichip(SHARDS, device=grid)
    print('dryrun_multichip(%d): %s agree with the unsharded step; the %d '
          'shards share one card, %s (%s)'
          % (SHARDS, ', '.join(legs), SHARDS, grid[0],
             torch.cuda.get_device_name(0)))

    phase('11 sharded live (main path)')
    rng = np.random.default_rng(1)
    state, base = example_inputs(LIVE_POOLS, seed=1)
    ref = state
    sh1 = tel.shard_state(clone(state), mesh)
    sh2 = tel.shard_state(clone(state), mesh2, axes2)
    live = tel.make_live_step()
    live1 = tel.make_live_step(mesh)
    smap = tel.make_shardmap_step(mesh2, axes2)
    control_step = ctl.make_control_step()
    mctl = ctl.make_control_step(mesh)
    c_ref = ctl.control_init(LIVE_POOLS, device=dev)
    c_sh = ctl.shard_control_state(ctl.control_init(LIVE_POOLS, device=dev),
                                   mesh)
    live_ms, ctl_ms, launches = [], [], 0
    for k in range(LIVE_TICKS):
        inp = tick_inputs(base, rng, k)
        inp1 = tel.shard_inputs(inp, mesh)
        ref, r_out, r_fleet = want = live(ref, inp)
        fir.fir_apply_cuda.launches = 0
        start.record()
        sh1, o1, f1 = got = live1(sh1, inp1)
        end.record()
        n = fir.fir_apply_cuda.launches
        check(n == SHARDS, 'sharded live tick %d: %d FIR launches' % (k, n))
        launches += n
        sh2, o2, f2 = got2 = smap(sh2, tel.shard_inputs(inp, mesh2, axes2))
        torch.cuda.synchronize()
        live_ms.append(start.elapsed_time(end))
        check_sharded('sharded live tick %d' % k, got, want)
        check_sharded('2x2 shard_map tick %d' % k, got2, want)

        cinp = ctl.ControlInputs(
            samples=inp.samples, sojourns=inp.sojourns,
            filtered=r_out['filtered'], target_delay=inp.target_delay,
            spares=inp.spares, maximum=inp.maximum, active=inp.active,
            reset=inp.reset, now_ms=inp.now_ms)
        c_want = control_step(c_ref, cinp)
        cinp1 = tuple(ctl.ControlInputs(
            samples=x.samples, sojourns=x.sojourns, filtered=o['filtered'],
            target_delay=x.target_delay, spares=x.spares, maximum=x.maximum,
            active=x.active, reset=x.reset, now_ms=x.now_ms)
            for x, o in zip(inp1, o1))
        start.record()
        c_got = mctl(c_sh, cinp1)
        end.record()
        torch.cuda.synchronize()
        ctl_ms.append(start.elapsed_time(end))
        check_control_sharded('sharded control tick %d' % k, c_got, c_want)
        c_ref, c_sh = c_want[0], c_got[0]
    live_ms_tick = sum(live_ms[1:]) / (len(live_ms) - 1)
    ctl_ms_step = sum(ctl_ms[1:]) / (len(ctl_ms) - 1)
    print('sharded live: %d ticks at %d pools over %d shards (and a 2x2 '
          'shard_map) equal the unsharded kernel step bit for bit; fir '
          'launches %d (%d per tick)' % (LIVE_TICKS, LIVE_POOLS, SHARDS,
                                         launches, launches // LIVE_TICKS))
    print('sharded live: first tick %.4f ms; ms/tick %.4f (mean of ticks '
          '1-%d, CUDA events); pools/s %.6g'
          % (live_ms[0], live_ms_tick, LIVE_TICKS - 1,
             LIVE_POOLS / (live_ms_tick / 1e3)))
    print('sharded control: %d steps bit-identical to the unsharded step; '
          'first step %.4f ms; ms/step %.5f (CUDA events)'
          % (LIVE_TICKS, ctl_ms[0], ctl_ms_step))
    del ref, sh1, sh2, state, base, c_ref, c_sh

    cols = health_example_columns(HEALTH_BACKENDS)
    h_inp = hl.health_inputs(HEALTH_BACKENDS, device=dev, **cols)
    health_step = hl.make_health_step()
    mhealth = hl.make_health_step(mesh)
    h_ref = hl.health_init(HEALTH_BACKENDS, device=dev)
    h_sh = hl.shard_health_state(hl.health_init(HEALTH_BACKENDS, device=dev),
                                 mesh)
    h_ms = []
    for k in range(HEALTH_TICKS):
        tick_inp = h_inp._replace(now_ms=torch.tensor(
            1000.0 * (k + 1), dtype=torch.float32, device=dev))
        want = health_step(h_ref, tick_inp)
        sharded_inp = hl.shard_health_inputs(tick_inp, mesh)
        start.record()
        got = mhealth(h_sh, sharded_inp)
        end.record()
        torch.cuda.synchronize()
        h_ms.append(start.elapsed_time(end))
        for part, g, w in zip(('state', 'verdicts', 'fleet'), got, want):
            check_same('sharded health tick %d %s' % (k, part), unshard(g), w)
        h_ref, h_sh = want[0], got[0]
    n_gray = int(want[2]['n_gray'])
    check(n_gray > 0, 'sharded health: no backend judged gray')
    h_ms_step = sum(h_ms[1:]) / (len(h_ms) - 1)
    print('sharded health: %d ticks at %d backends bit-identical to the '
          'unsharded step (n_gray %d); first step %.4f ms; ms/step %.5f '
          '(CUDA events)' % (HEALTH_TICKS, HEALTH_BACKENDS, n_gray, h_ms[0],
                             h_ms_step))

    phase('12 mesh sampler (main path)')
    work = SamplerWorkload(SAMPLER_POOLS, SAMPLER_BACKENDS)
    meshed = FleetSampler(work.options(mesh=mesh))
    plain = FleetSampler(work.options())
    s_ms, s_launches, drops = [], 0, 0
    for k in range(SAMPLER_TICKS):
        work.advance()
        fir.fir_apply_cuda.launches = 0
        t0 = time.perf_counter()
        got = meshed.sample_once()
        s_ms.append((time.perf_counter() - t0) * 1e3)
        n = fir.fir_apply_cuda.launches
        check(n == SHARDS, 'mesh sampler tick %d: %d FIR launches' % (k, n))
        s_launches += n
        want = plain.sample_once()
        drops += check_mesh_records('mesh sampler tick %d' % k, got, want)
    snap = meshed.snapshot()['mesh']
    check(snap == {'axes': ['pools'], 'shape': {'pools': SHARDS},
                   'n_devices': SHARDS}, 'mesh sampler snapshot %r' % snap)
    check(drops > 0, 'mesh sampler: no CoDel drop')
    meshed.stop()
    plain.stop()
    s_ms_tick = sum(s_ms[1:]) / (len(s_ms) - 1)
    print('mesh sampler: %d ticks at %d pools over %d shards equal the '
          'plain sampler on the card; %d drops; gray %s; fir launches %d'
          % (SAMPLER_TICKS, SAMPLER_POOLS, SHARDS, drops,
             got['health']['gray'], s_launches))
    print('mesh sampler: first tick %.3f ms; wall ms/tick %.4f (mean of '
          'ticks 1-%d, host clock, ends in a device sync); pools/s %.6g'
          % (s_ms[0], s_ms_tick, SAMPLER_TICKS - 1,
             SAMPLER_POOLS / (s_ms_tick / 1e3)))
    return {
        'shards': SHARDS,
        'sharded_live_ms_per_tick': live_ms_tick,
        'sharded_live_pools_per_s': LIVE_POOLS / (live_ms_tick / 1e3),
        'sharded_control_ms_per_step': ctl_ms_step,
        'sharded_health_ms_per_step': h_ms_step,
        'mesh_sampler_wall_ms_per_tick': s_ms_tick,
        'mesh_sampler_pools_per_s': SAMPLER_POOLS / (s_ms_tick / 1e3),
        'sharded_live_launches': launches,
        'mesh_sampler_launches': s_launches,
    }


def check_mesh_records(tag, got, want):
    """The mesh sampler's tick record against the plain one's on the
    same card: every input, per-pool output, decision and health
    verdict exactly; the float fleet aggregates to RTOL/ATOL (their
    sums run in another order). Returns the tick's drops."""
    gp, wp = got['pools'], want['pools']
    check(gp.tp_rows == wp.tp_rows, '%s: rows differ' % tag)
    for name, col in wp.tp_cols.items():
        check(np.array_equal(gp.tp_cols[name], col),
              '%s: input %s differs' % (tag, name))
    for name, col in wp.tp_out.items():
        check(np.array_equal(gp.tp_out[name], col),
              '%s: %s differs' % (tag, name))
    for name, v in want['fleet'].items():
        check(abs(got['fleet'][name] - v) <= ATOL + RTOL * abs(v),
              '%s: fleet %s %r vs %r' % (tag, name, got['fleet'][name], v))
    check(got['fleet']['n_pools'] == want['fleet']['n_pools'],
          '%s: n_pools' % tag)
    gc, wc = got['control'], want['control']
    for name in ('applied', 'rejected', 'skipped', 'epoch', 'step_ms'):
        check(gc[name] == wc[name], '%s: control %s' % (tag, name))
    for name, v in wc['decisions'].items():
        check(np.array_equal(gc['decisions'][name], v),
              '%s: decision %s differs' % (tag, name))
    for name, v in wc['fleet'].items():
        check(abs(gc['fleet'][name] - v) <= RTOL * abs(v),
              '%s: control %s' % (tag, name))
    check(got['health'] == want['health'], '%s: health differs' % tag)
    return int(wp.tp_out['drop'].sum())


def check_reduced(tag, got, want):
    """A reduced pass row (reduce_fleet, reduce_control or
    reduce_health) against the CPU twin's: counts, flags and gray sets
    exactly, floats to RTOL/ATOL."""
    check(set(got) == set(want), '%s: keys differ' % tag)
    for name, v in want.items():
        g = got[name]
        if isinstance(v, (bool, int, list)) or name == 'n_pools':
            check(g == v, '%s: %s %r vs %r' % (tag, name, g, v))
        else:
            check(abs(g - v) <= ATOL + RTOL * abs(v),
                  '%s: %s %r vs %r' % (tag, name, g, v))


def router_phase(dev, run):
    """Phase 13. ``run`` runs a coroutine on the main thread's loop.
    Returns (the card's runtime and workload, still running, and the
    phase's numbers)."""
    phase('13 router fleet passes (main path)')
    cold = build.BUILD_DIR.parent / 'torch_kernels_cold'
    shutil.rmtree(cold, ignore_errors=True)
    warm = build.BUILD_DIR
    build.set_build_dir(cold)
    nvcc_before = build.nvcc_runs
    card_work = ShardedWorkload(SHARDS, ROUTER_POOLS, SAMPLER_BACKENDS)
    cpu_work = ShardedWorkload(SHARDS, ROUTER_POOLS, SAMPLER_BACKENDS)
    card = FleetRuntime(card_work, card_work.options())
    twin = FleetRuntime(cpu_work, cpu_work.options(device='cpu'))

    # The four shard loops launch the kernel at once, so their first
    # launches race to build it into the empty directory.
    taps = fir.gen_taps(TAPS, device=dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    windows = [torch.rand((ROUTER_POOLS, TAPS), generator=gen, device=dev)
               for _ in range(SHARDS)]

    async def race():
        return await asyncio.gather(*(
            card_work.run_on(sid, fir.fir_apply_cuda, windows[sid], taps)
            for sid in range(SHARDS)))
    raced = run(race())
    torch.cuda.synchronize()
    errs = []
    for sid, (got, w) in enumerate(zip(raced, windows)):
        want = fir.fir_apply_plain(w, taps)
        torch.testing.assert_close(
            got, want, rtol=RTOL, atol=ATOL,
            msg=lambda m: 'router race, shard %d: %s' % (sid, m))
        errs.append(max_errs(got, want))
    built = sorted(p.name for p in cold.iterdir())
    check(build.nvcc_runs - nvcc_before == 1 and
          built == [build.library_path('fir').name],
          'router: %d nvcc runs from the empty build directory, which '
          'holds %s' % (build.nvcc_runs - nvcc_before, built))
    print('router: %d shard loops launched the kernel at once from an '
          'empty build directory; one nvcc ran; max_abs_err %.3e'
          % (SHARDS, max(e[0] for e in errs)))
    build.set_build_dir(warm)
    mesh2 = Mesh(np.array([torch.device('cuda', 0)] * SHARDS,
                          dtype=object).reshape(2, 2), ('host', 'chip'))
    ms = {kind: [] for kind, _ in ROUTER_PASSES}
    edge = drops = meshed = 0
    fir.fir_apply_cuda.launches = 0
    for kind, n_passes in ROUTER_PASSES:
        for k in range(n_passes):
            tag = 'router %s pass %d' % (kind, k)
            card_work.advance()
            cpu_work.advance()
            mesh = mesh2 if kind == 'sample' and k % 2 else None
            before = fir.fir_apply_cuda.launches
            t0 = time.perf_counter()
            if kind == 'sample':
                got = run(card.sample_fleet(mesh=mesh))
            else:
                got = run(getattr(card, kind + '_fleet')())
            ms[kind].append((time.perf_counter() - t0) * 1e3)
            n = fir.fir_apply_cuda.launches - before
            check(n == SHARDS, '%s: %d FIR launches' % (tag, n))
            want = run(getattr(twin, kind + '_fleet')())
            check_reduced(tag, got, want)
            if mesh is not None:
                meshed += 1
                check_reduced(tag + ' flat', got, reduce_fleet(
                    [s.fs_latest['fleet'] for _, s in
                     sorted(card.rt_samplers.items())]))
            for sid in range(SHARDS):
                e, d = check_sampler_records(
                    '%s shard %d' % (tag, sid),
                    card.rt_samplers[sid].fs_latest,
                    twin.rt_samplers[sid].fs_latest)
                edge += e
                drops += d
    launches = fir.fir_apply_cuda.launches
    n_total = sum(n for _, n in ROUTER_PASSES)
    check(launches == SHARDS * n_total,
          'router: %d FIR launches in %d passes' % (launches, n_total))
    check(drops > 0, 'router: no CoDel drop')
    gray = card.health_snapshot()['gray']
    check(gray == ['backend-7'], 'router: health judged %r gray' % gray)
    run(twin.stop())
    cpu_work.close()
    out = {'launches': launches, 'passes': n_total,
           'pools': SHARDS * ROUTER_POOLS, 'shards': SHARDS,
           'first_pass_ms': ms['sample'][0], 'max_abs_err': max(
               e[0] for e in errs), 'max_rel_err': max(e[1] for e in errs)}
    print('router: %d passes over %d shards x %d pools agree with the CPU '
          'twin (%d sample, %d of them reduced over a 2x2 mesh; %d '
          'control; %d health); %d drops; %d row-ticks on the target '
          'boundary; gray %s; fir launches %d (%d per pass)'
          % (n_total, SHARDS, ROUTER_POOLS, ROUTER_PASSES[0][1], meshed,
             ROUTER_PASSES[1][1], ROUTER_PASSES[2][1], drops, edge, gray,
             launches, launches // n_total))
    for kind, times in ms.items():
        steady = times[1:]
        mean = sum(steady) / len(steady)
        out['%s_wall_ms_per_pass' % kind] = mean
        out['%s_pools_per_s' % kind] = SHARDS * ROUTER_POOLS / (mean / 1e3)
        print('router %s: first pass %.3f ms; wall ms/pass %.4f (mean of '
              'passes 1-%d, host clock, ends in the device-to-host '
              'copies); pools/s %.6g'
              % (kind, times[0], mean, len(times) - 1,
                 SHARDS * ROUTER_POOLS / (mean / 1e3)))
    return card, card_work, out


def surfaces_phase(run, card, card_work):
    """Phase 14, over phase 13's runtime on the card."""
    phase('14 surfaces')
    for sid in range(SHARDS):
        check(run(card_work.run_on(sid, host.start_loop_lag_sampler, 5.0)),
              'loop-lag sampler refused on shard %d' % sid)
    time.sleep(0.25)
    samples = [run(card_work.run_on(sid, host.loop_lag_stats))['samples']
               for sid in range(SHARDS)]
    check(all(n > 0 for n in samples),
          'loop-lag samples per shard loop: %s' % samples)
    card_work.advance()
    fleet = run(card.sample_fleet())
    lag = fleet['loop_lag_p99_us']
    check(lag > 0.0, 'fleet loop_lag_p99_us %r' % lag)
    print('loop lag: armed on %d shard loops, samples %s; fleet '
          'loop_lag_p99_us %.3f' % (SHARDS, samples, lag))

    card_work.monitor.attach_fleet_sampler(card.rt_samplers[0])

    async def serve_and_fetch():
        server = await http_server.serve_monitor(monitor=card_work.monitor)
        base = 'http://127.0.0.1:%d' % server.sockets[0].getsockname()[1]

        def fetch(method, path):
            req = urllib.request.Request(base + path, method=method)
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    return r.status, r.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()

        try:
            out = {}
            for method, path in (('GET', '/kang/health'),
                                 ('GET', '/kang/health?limit=1'),
                                 ('GET', '/kang/health?bogus=1'),
                                 ('POST', '/kang/health'),
                                 ('GET', '/kang/nowhere'),
                                 ('GET', '/kang/fleet')):
                out[method, path] = await asyncio.to_thread(fetch, method,
                                                            path)
            return out
        finally:
            server.close()
            await server.wait_closed()

    got = run(serve_and_fetch())
    status, body = got['GET', '/kang/health']
    snap = hl.health_snapshot()
    check(status == 200 and json.loads(body) == json.loads(json.dumps(
        snap, default=repr)), '/kang/health differs from health_snapshot()')
    check(json.loads(body)['fleet']['gray'] == ['backend-7'],
          '/kang/health gray %r' % json.loads(body)['fleet']['gray'])
    limited = json.loads(got['GET', '/kang/health?limit=1'][1])
    check(len(limited['monitors']) == 1 and
          limited['n_monitors'] == snap['n_monitors'],
          '/kang/health?limit=1 kept %d rows' % len(limited['monitors']))
    for key, code in ((('GET', '/kang/health?bogus=1'), 400),
                      (('POST', '/kang/health'), 405),
                      (('GET', '/kang/nowhere'), 404)):
        check(got[key][0] == code, '%s %s: %d' % (*key, got[key][0]))
    fleet_snap = json.loads(got['GET', '/kang/fleet'][1])
    check(fleet_snap['attached'] and fleet_snap['shard'] == 0 and
          fleet_snap['ticks'] == card.rt_samplers[0].fs_ticks,
          "/kang/fleet does not show shard 0's sampler")
    card_work.monitor.detach_fleet_sampler()
    print('kang: /kang/health equals health_snapshot() (%d monitors, gray '
          '%s), ?limit=1 keeps 1, ?bogus=1 400, POST 405, unknown 404; '
          '/kang/fleet shows shard 0 at tick %d (%d bytes)'
          % (snap['n_monitors'], snap['fleet']['gray'],
             fleet_snap['ticks'], len(got['GET', '/kang/fleet'][1])))

    recorded = []
    dumps = []

    class Capture(logging.Handler):
        def emit(self, record):
            dumps.append(record.getMessage())

    capture = Capture()
    log = logging.getLogger('cueball.debug')
    log.addHandler(capture)
    before = signal.signal(signal.SIGUSR2,
                           lambda sig, frame: recorded.append(sig))
    states = []
    try:
        prev = debug.install_debug_handler(signal.SIGUSR2)
        # The first signal turns stack capture and the samplers on, the
        # second turns them off again.
        for k in (1, 2):
            os.kill(os.getpid(), signal.SIGUSR2)
            deadline = time.monotonic() + 10.0
            while not (len(recorded) == len(dumps) == k) and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            states.append((utils.stack_traces_enabled(),
                           profile.sampler_running()))
        debug.uninstall_debug_handler(prev, signal.SIGUSR2)
    finally:
        signal.signal(signal.SIGUSR2, before)
        log.removeHandler(capture)
    check(recorded == [signal.SIGUSR2] * 2,
          'the chained handler ran %d times' % len(recorded))
    check(len(dumps) == 2, 'the port handler logged %d dumps' % len(dumps))
    check(states == [(True, True), (False, False)],
          'SIGUSR2 toggled stack capture and the profiler as %r' % states)
    gray_lines = [ln for ln in dumps[0].splitlines()
                  if ln.startswith('   gray backend-7 ')]
    sampler_lines = [ln for ln in dumps[0].splitlines()
                     if ln.startswith('  fleet_sampler ')]
    check(gray_lines, 'the SIGUSR2 dump holds no gray backend-7 line')
    check(len(sampler_lines) >= SHARDS, 'the dump lists %d samplers'
          % len(sampler_lines))
    print('SIGUSR2: the port dump and the chained handler both ran, twice '
          '(capture and profiler on, then off); %d sampler lines, %d gray '
          'lines, e.g. %r' % (len(sampler_lines), len(gray_lines),
                              gray_lines[0].strip()))
    run(card.stop())
    host.stop_loop_lag_sampler()
    card_work.close()


def check_replay(got, want):
    """Phase 15: a replay against another on the same window: floats to
    RTOL/ATOL, ``drop`` exactly, ``target`` and ``clamped`` exactly off
    their rounding boundary. Returns (max abs error of ``filtered``,
    the rows on the boundary)."""
    edge = convert.target_near_boundary(
        want['outs']['filtered'], want['samples'], want['spares'])
    for name, w in want['outs'].items():
        g = got['outs'][name]
        if name in ('target', 'clamped'):
            check(np.array_equal(g[~edge], w[~edge]),
                  'telemetry_replay: %s differs off the rounding boundary'
                  % name)
        elif w.dtype.kind in 'biu':
            check(np.array_equal(g, w), 'telemetry_replay: %s differs'
                  % name)
        else:
            check(np.allclose(g, w, rtol=RTOL, atol=ATOL),
                  'telemetry_replay: %s differs' % name)
    for name, w in want['fleets'].items():
        check(np.allclose(got['fleets'][name], w, rtol=RTOL, atol=ATOL),
              'telemetry_replay: aggregate %s differs' % name)
    err = np.abs(got['outs']['filtered'] - want['outs']['filtered']).max()
    return float(err), int(edge.sum())


def examples_phase():
    """Phase 15. Returns the examples' FIR launches."""
    phase('15 examples')
    fir.fir_apply_cuda.launches = 0
    replay = telemetry_replay.main(device='cuda')
    n_replay = fir.fir_apply_cuda.launches
    check(n_replay == telemetry_replay.T,
          'telemetry_replay: %d FIR launches for %d ticks'
          % (n_replay, telemetry_replay.T))
    fir.fir_apply_cuda.launches = 0
    demo = fleet_mesh_sampler.main(device='cuda')
    n_demo = fir.fir_apply_cuda.launches
    want = fleet_mesh_sampler.TICKS * (demo['shards'] + 1)
    check(n_demo == want, 'fleet_mesh_sampler: %d FIR launches, want %d'
          % (n_demo, want))
    # Both again with the plain FIR on the CPU, on the same seeded
    # inputs: the card's results are held against these.
    replay_err, replay_edge = check_replay(
        replay, telemetry_replay.main(device='cpu'))
    plain = fleet_mesh_sampler.main(device='cpu')
    check(np.array_equal(demo['drop'], plain['drop']),
          'fleet_mesh_sampler: drops differ from the CPU run')
    check(np.allclose(demo['filtered'], plain['filtered'], rtol=RTOL,
                      atol=ATOL),
          'fleet_mesh_sampler: filtered differs from the CPU run')
    demo_err = float(np.abs(demo['filtered'] - plain['filtered']).max())
    print('examples: telemetry_replay peak %.2f at tick %d, %d FIR '
          'launches, agrees with the CPU replay (%d drops; max_abs_err '
          '%.3e; %d row-ticks on the target boundary); fleet_mesh_sampler '
          '%d/%d ticks agree over %d shards, %d FIR launches, agrees with '
          'the CPU demo (%d drops; max_abs_err %.3e)'
          % (replay['peak_overload'], replay['peak_tick'], n_replay,
             replay['drops'], replay_err, replay_edge, demo['agree'],
             demo['ticks'], demo['shards'], n_demo, demo['drops'],
             demo_err))
    asyncio.run(discovery_examples())
    return n_replay + n_demo


async def discovery_examples():
    """Phase 15's DNS half: the multiplexed-set client's ``MuxClient``
    over a ``DNSResolver`` that finds its three servers in SRV records,
    one of them then dropped from the set; and ``cbresolve`` in DNS and
    static mode. One nameserver in-process answers both."""
    servers = [await multiplexed_set_client.DemoServer().start()
               for _ in range(3)]
    ports = [s.port for s in servers]
    zone = discovered_fleet.fleet_zone(1, CBRESOLVE_PORTS)
    srv_name = '%s.%s' % (MUX_SERVICE, MUX_DOMAIN)
    for j, port in enumerate(ports):
        zone.add_srv_backend(srv_name, 'm%d.%s' % (j, MUX_DOMAIN), port,
                             '127.0.0.1', ttl=1, addr_ttl=1)
    ns_transport, ns, ns_port = await discovered_fleet.serve_zone(zone)
    nameserver = '127.0.0.1@%d' % ns_port
    with discovered_fleet.pinned_v4_only():
        try:
            resolver = DNSResolver({
                'domain': MUX_DOMAIN, 'service': MUX_SERVICE,
                'resolvers': [nameserver],
                'recovery': {'default': {'timeout': 1000, 'retries': 3,
                                         'delay': 100}}})
            client = multiplexed_set_client.MuxClient(resolver, target=3,
                                                      maximum=4)
            removed = []
            resolver.on('removed', removed.append)
            resolver.start()
            first, after = MUX_CALLS
            got = await asyncio.gather(*[client.call('square', {'x': i})
                                         for i in range(first)])
            check([r['value'] for r in got] == [i * i for i in range(first)]
                  and {r['port'] for r in got} == set(ports),
                  'mux over DNS: %r' % got[:4])
            zone.remove(srv_name, 'SRV')
            for j, port in enumerate(ports[1:], 1):
                zone.add(srv_name, 'SRV', 'm%d.%s' % (j, MUX_DOMAIN),
                         ttl=1, port=port)
            await discovered_fleet.wait_until(lambda: removed, 10.0,
                                              'mux: server 0 leaving')
            await servers[0].kill()
            got = await asyncio.gather(*[client.call('square', {'x': i})
                                         for i in range(after)])
            check({r['port'] for r in got} == set(ports[1:]),
                  'mux after the swap: served by %r'
                  % sorted({r['port'] for r in got}))
            await client.stop()
            resolver.stop()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = await asyncio.to_thread(cli.main, [
                    '-r', nameserver, '-s', discovered_fleet.SERVICE,
                    discovered_fleet.service_name(0)])
            want = sorted('%-16s %5d %s' % (
                '127.0.0.1', CBRESOLVE_PORTS[j],
                discovered_fleet.backend_key(j, CBRESOLVE_PORTS))
                for j in range(discovered_fleet.TARGETS))
            check(rc == 0 and sorted(out.getvalue().splitlines()) == want,
                  'cbresolve (DNS): exit %d, %r' % (rc, out.getvalue()))
            static = io.StringIO()
            with contextlib.redirect_stdout(static):
                rc_static = await asyncio.to_thread(
                    cli.main, ['-S', '127.0.0.1:9000', '127.0.0.1:9001'])
            check(rc_static == 0 and len(static.getvalue().splitlines()) == 2,
                  'cbresolve (static): exit %d, %r' % (rc_static,
                                                       static.getvalue()))
        finally:
            for s in servers[1:]:
                await s.kill()
            ns_transport.close()
    print('examples: multiplexed set over DNS: %d calls over %d servers, '
          'then %d over the %d left after one left the SRV set; cbresolve '
          'listed the %d SRV targets of %s (%d queries answered)'
          % (first, len(ports), after, len(ports) - 1,
             discovered_fleet.TARGETS, discovered_fleet.service_name(0),
             sum(ns.answered.values())))


def bench_phase(kind, smi):
    """Phase 16. Returns the bench's FIR launches and the (max abs, max
    rel) errors of the kernel at every fleet size the bench stepped."""
    phase('16 bench stages (main path)')
    recs = []
    fir.fir_apply_cuda.launches = 0
    t0 = time.perf_counter()
    bench.run_stages(recs.append)
    launches = fir.fir_apply_cuda.launches
    seconds = time.perf_counter() - t0
    rec = {}
    for r in recs:
        rec.update(r)
    rec['stages_completed'] = [r['stage'] for r in recs]
    del rec['stage']
    print('bench ' + json.dumps(rec, sort_keys=True))
    check(rec['stages_completed'] == bench.stage_names(),
          'bench: stages %r' % rec['stages_completed'])
    bad = bench.bad_rates(rec)
    check(not bad, 'bench: rates not finite and positive: %r' % bad)
    for stage in BENCH_KERNEL_STAGES:
        check(rec['fir_launches_' + stage] > 0,
              'bench: the FIR kernel did not launch in %s' % stage)
    check(rec['fir_launches_step_plain'] == 0,
          'bench: step_plain launched the FIR kernel')
    check(rec['default_is_kernel'] is True,
          'bench: the default step does not launch the kernel')
    staged = sum(v for k, v in rec.items() if k.startswith('fir_launches_'))
    check(staged == launches, 'bench: stages count %d FIR launches, the '
          'counter %d' % (staged, launches))
    check(rec['device_name'] == kind and rec['nvidia_smi'] == smi,
          'bench: device %r / %r' % (rec['device_name'], rec['nvidia_smi']))

    # The stages launched the kernel at every size of step_pools, most
    # of which phases 2-5 do not hold: hold the kernel step and one live
    # tick against the plain step at each, on the bench's own inputs
    # (a fresh state's windows hold one nonzero sample, so its FIR is
    # exact) and on them with every window filled with seeded loads.
    # These launches are the comparison's, not the bench's.
    errs, edge = [], 0
    live = tel.make_live_step()
    gen = torch.Generator(device='cuda').manual_seed(16)
    fir.fir_apply_cuda.launches = 0
    sizes = bench.step_pools()
    for n in sizes:
        state, inp = example_inputs(n)
        filled = state._replace(windows=torch.rand(
            state.windows.shape, generator=gen, device='cuda') * 8.0)
        for which, st in (('fresh', state), ('filled', filled)):
            want = tel.fleet_step_plain(clone(st), inp)
            for tag, step in (('kernel step', tel.fleet_step_cuda),
                              ('live tick', live)):
                tag = 'bench %s P=%d %s' % (tag, n, which)
                got = step(clone(st), inp)
                torch.cuda.synchronize()
                errs.append(max_errs(*compare_step(tag, got, want)))
                edge += check_target(tag, got[1], want[1], inp)
    checked = fir.fir_apply_cuda.launches
    check(checked == 4 * len(sizes), 'bench: %d FIR launches in %d '
          'comparisons' % (checked, 4 * len(sizes)))
    print('bench: the kernel step and a live tick agree with the plain '
          'step at P=%s, fresh and filled windows (max_abs_err %.3e, '
          'max_rel_err %.3e; %d rows on the target boundary; %d '
          'comparison launches, not counted)'
          % (','.join(map(str, sizes)), max(e[0] for e in errs),
             max(e[1] for e in errs), edge, checked))
    print('bench: %d stages in %.3f s, %d FIR launches; live %.6g pools/s, '
          'kernel step %.6g, plain step %.6g, scan %.6g; dispatch floor '
          '%.6g us; code_hash %s' % (
              len(recs), seconds, launches, rec['pools_per_sec_live'],
              rec['pools_per_sec_kernel'], rec['pools_per_sec_plain'],
              rec['pools_per_sec_scan'], rec['dispatch_floor_us'],
              bench.code_hash()))
    return launches, errs


def fleet_phase():
    """Phase 17. Returns the example's FIR launches."""
    phase('17 inference fleet (main path)')
    # The JAX package and JAX are made unimportable before anything is
    # imported: the script runs on the port's own pool layer.
    code = ("import runpy, sys\n"
            "for name in ('cueball_tpu', 'jax', 'jaxlib'):\n"
            "    sys.modules[name] = None\n"
            "sys.argv = [%r, '--requests', %r, '--twin-device', 'cpu']\n"
            "runpy.run_path(%r, run_name='__main__')\n"
            % (FLEET_SCRIPT, str(FLEET_REQUESTS), FLEET_SCRIPT))
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=300)
    print(r.stdout.rstrip())
    check(r.returncode == 0, 'inference fleet: exit %d: %s' % (
        r.returncode, r.stderr.strip()[-2000:]))
    res = json.loads(r.stdout.splitlines()[-1])
    ticks = res['ticks']
    check(res['ok'] == FLEET_REQUESTS and res['failed'] == 0,
          'inference fleet: %d ok, %d failed' % (res['ok'], res['failed']))
    check(ticks == FLEET_REQUESTS // inference_fleet_client.TICK_EVERY + 1
          and res['agree'] == [ticks],
          'inference fleet: %r of %d ticks agree with the CPU twin'
          % (res['agree'], ticks))
    check(res['fir_launches'] == ticks,
          'inference fleet: %d FIR launches in %d ticks'
          % (res['fir_launches'], ticks))
    check(res['fleet']['n_pools'] >= 1.0, 'inference fleet: no pool sampled')
    print('inference fleet: %d requests, %d ticks agree with the CPU twin '
          '(max_abs_err %.3e), %d FIR launches'
          % (res['ok'], ticks, res['max_abs_err'][0], res['fir_launches']))
    return res['fir_launches']


def pool_fleet_phase(smi):
    """Phase 19. Returns the FIR launches and the phase's numbers."""
    phase('19 pool fleet (main path)')
    need = 2 * pool_fleet.POOLS * pool_fleet.MAXIMUM + FD_HEADROOM
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    print('ulimit -n: soft %d, hard %d; the phase needs %d' % (soft, hard,
                                                                need))
    if soft < need and (hard == resource.RLIM_INFINITY or hard >= need):
        resource.setrlimit(resource.RLIMIT_NOFILE, (need, hard))
        soft = need
    check(soft >= need, 'pool fleet: ulimit -n %d is below the %d sockets '
          'the phase needs' % (soft, need))
    fir.fir_apply_cuda.launches = 0
    res = asyncio.run(pool_fleet.run())
    launches = fir.fir_apply_cuda.launches
    claims, ticks = pool_fleet.CLAIMS, res['ticks']
    check(res['device'].startswith('cuda'),
          'pool fleet: sampler on %s' % res['device'])
    check(res['served'] == claims and not res['failed'],
          'pool fleet: %d of %d claims served; %s'
          % (res['served'], claims, res['failed'][:3]))
    check(ticks == claims // pool_fleet.TICK_EVERY + 2,
          'pool fleet: %d ticks' % ticks)
    check(len(res['twin_records']) == ticks, 'pool fleet: twin ticks')
    edge = 0
    for k, (got, want) in enumerate(zip(res['records'],
                                        res['twin_records'])):
        check(got['fleet']['n_pools'] == pool_fleet.POOLS,
              'pool fleet tick %d: %r pools sampled'
              % (k, got['fleet']['n_pools']))
        edge += check_sampler_records('pool fleet tick %d' % k, got, want,
                                      counts=False)[0]
    check(launches == res['fir_launches'] == ticks,
          'pool fleet: %d FIR launches in %d ticks' % (launches, ticks))
    reached = res['reached']
    check(reached['applied'] > 0 and reached['decisions'] > 0,
          'pool fleet: no control decision reached a pool: %r' % reached)
    check(reached['advisories'] > 0,
          'pool fleet: no advisory reached a pool: %r' % reached)
    print('pool fleet: %d claims over %d pools served; %d ticks agree with '
          'the CPU twin (%d row-ticks on the target boundary); %d FIR '
          'launches; %d decisions applied, %d pools hold epoch %d, %d the '
          'last advisory' % (res['served'], pool_fleet.POOLS, ticks, edge,
                             launches, reached['applied'],
                             reached['decisions'], reached['epoch'],
                             reached['advisories']))
    alone = asyncio.run(pool_fleet.run(twin_device=None))
    check(alone['served'] == claims and not alone['failed'],
          'pool fleet without twin: %d served' % alone['served'])
    check(alone['fir_launches'] == alone['ticks'],
          'pool fleet without twin: %d launches in %d ticks'
          % (alone['fir_launches'], alone['ticks']))
    out = {'pools': pool_fleet.POOLS, 'claims': claims,
           'concurrency': pool_fleet.CONCURRENCY, 'ticks': ticks,
           'fir_launches': launches,
           'claims_per_s_with_twin': res['claims_per_s'],
           'claims_per_s': alone['claims_per_s'],
           'ms_per_tick': alone['ms_per_tick'],
           'ms_per_tick_with_twin': res['ms_per_tick'],
           'wall_s': alone['wall_s'], 'nvidia_smi': smi}
    print('pool fleet: %.1f claims/s, %.4f ms per card sampler tick (host '
          'clock, ends in a device sync), without the twin; %s'
          % (alone['claims_per_s'], alone['ms_per_tick'], smi))
    return launches, out


def discovered_fleet_phase(smi):
    """Phase 20. Returns the FIR launches and the phase's numbers."""
    phase('20 discovered fleet (main path)')
    fleet = discovered_fleet
    need = 2 * fleet.SERVICES * fleet.MAXIMUM + FD_HEADROOM
    soft, _hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    check(soft >= need, 'discovered fleet: ulimit -n %d is below the %d '
          'sockets the phase needs' % (soft, need))
    fir.fir_apply_cuda.launches = 0
    res = asyncio.run(fleet.run())
    launches = fir.fir_apply_cuda.launches
    claims, ticks = fleet.CLAIMS, res['ticks']
    check(res['device'].startswith('cuda'),
          'discovered fleet: sampler on %s' % res['device'])
    check(res['served'] == claims and not res['failed'],
          'discovered fleet: %d of %d claims served; %s'
          % (res['served'], claims, res['failed'][:3]))
    check(res['agent'] == {'ok': fleet.AGENT_REQUESTS, 'failed': 0},
          'discovered fleet: agent %r' % res['agent'])
    check(ticks == claims // fleet.TICK_EVERY + 2,
          'discovered fleet: %d ticks' % ticks)
    check(len(res['twin_records']) == ticks, 'discovered fleet: twin ticks')
    edge = 0
    for k, (got, want) in enumerate(zip(res['records'],
                                        res['twin_records'])):
        check(got['fleet']['n_pools'] == fleet.SERVICES,
              'discovered fleet tick %d: %r pools sampled'
              % (k, got['fleet']['n_pools']))
        edge += check_sampler_records('discovered fleet tick %d' % k, got,
                                      want, counts=False)[0]
    check(launches == res['fir_launches'] == ticks,
          'discovered fleet: %d FIR launches in %d ticks' % (launches,
                                                             ticks))
    swap = res['swap']
    n = fleet.SERVICES
    check(swap['pools_removed_b0'] == n and swap['pools_added_b8'] == n,
          'discovered fleet: swap seen by %r' % swap)
    check(swap['pools_on_server0'] == 0,
          'discovered fleet: %d pools still hold a connection to server 0'
          % swap['pools_on_server0'])
    check(swap['pools_listing_new_set'] == n,
          'discovered fleet: %d pools list the new SRV set'
          % swap['pools_listing_new_set'])
    check(res['by_server'].get(fleet.TARGETS, 0) > 0,
          'discovered fleet: server 8 served nothing: %r' % res['by_server'])
    check(swap['b8_row'] < swap['health_rows'] and swap['b8_in_health'],
          'discovered fleet: the health table has no row for the new '
          'backend: %r' % swap)
    reached = res['reached']
    check(reached['applied'] > 0 and reached['decisions'] > 0
          and reached['advisories'] > 0,
          'discovered fleet: the sampler reached no pool: %r' % reached)
    print('discovered fleet: %d claims over %d DNS-discovered pools '
          'served, %r per server; %d agent requests by hostname; %d ticks '
          'agree with the CPU twin (%d row-ticks on the target boundary); '
          '%d FIR launches; swap seen by all %d pools in %.3f s, health '
          'row %d of %d; nameserver answered %r (%d SRV refreshes); %d '
          'decisions applied' % (res['served'], n, res['by_server'],
                                 res['agent']['ok'], ticks, edge, launches,
                                 n, swap['seconds'], swap['b8_row'],
                                 swap['health_rows'], res['answered'],
                                 res['srv_refreshes'], reached['applied']))
    alone = asyncio.run(fleet.run(twin_device=None))
    check(alone['served'] == claims and not alone['failed']
          and alone['agent']['failed'] == 0,
          'discovered fleet without twin: %d served' % alone['served'])
    check(alone['fir_launches'] == alone['ticks'],
          'discovered fleet without twin: %d launches in %d ticks'
          % (alone['fir_launches'], alone['ticks']))
    out = {'pools': n, 'claims': claims, 'concurrency': fleet.CONCURRENCY,
           'ticks': ticks, 'fir_launches': launches,
           'claims_per_s_with_twin': res['claims_per_s'],
           'claims_per_s': alone['claims_per_s'],
           'ms_per_tick': alone['ms_per_tick'],
           'ms_per_tick_with_twin': res['ms_per_tick'],
           'swap_s': [res['swap']['seconds'], alone['swap']['seconds']],
           'discover_s': [res['discover_s'], alone['discover_s']],
           'answered': [res['answered_with_agent'],
                        alone['answered_with_agent']],
           'srv_refreshes': [res['srv_refreshes'], alone['srv_refreshes']],
           'wall_s': alone['wall_s'], 'nvidia_smi': smi}
    print('discovered fleet: %.1f claims/s, %.4f ms per card sampler tick '
          '(host clock, ends in a device sync), without the twin; %s'
          % (alone['claims_per_s'], alone['ms_per_tick'], smi))
    return launches, out


def check_pass_rows(tag, kind, row, pairs):
    """A router pass's reduced row against the same reduction of the
    twins' records: counts exactly, floats to RTOL/ATOL. The twins act
    on no pool, so a control row's applied, rejected and skipped counts
    are not held."""
    if kind == 'sample':
        want = reduce_fleet([w['fleet'] for _, w in pairs])
    elif kind == 'control':
        want = ctl.reduce_control([w['control'] for _, w in pairs])
        want = {k: v for k, v in want.items()
                if k not in ('applied', 'rejected', 'skipped')}
    else:
        want = hl.reduce_health([w['health'] for _, w in pairs])
    for name, v in want.items():
        g = row[name]
        if isinstance(v, (bool, int, list, str)):
            check(g == v, '%s: %s %r vs %r' % (tag, name, g, v))
        else:
            check(abs(g - v) <= ATOL + RTOL * abs(v),
                  '%s: %s %r vs %r' % (tag, name, g, v))


def sharded_fleet_phase(smi):
    """Phase 21. Returns the FIR launches and the phase's numbers."""
    phase('21 sharded fleet (main path)')
    t_phase = time.perf_counter()
    fleet = sharded_fleet
    need = 2 * fleet.POOLS * fleet.MAXIMUM + FD_HEADROOM
    soft, _hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    print('ulimit -n: soft %d; the phase needs %d' % (soft, need))
    check(soft >= need, 'sharded fleet: ulimit -n %d is below the %d '
          'sockets the phase needs' % (soft, need))
    fir.fir_apply_cuda.launches = 0
    res = asyncio.run(fleet.run())
    launches = fir.fir_apply_cuda.launches
    claims, shards, passes = fleet.CLAIMS, fleet.SHARDS, res['passes']
    check(res['device'].startswith('cuda'),
          'sharded fleet: samplers on %s' % res['device'])
    check(res['served'] == claims and not res['failed'],
          'sharded fleet: %d of %d claims served; %s'
          % (res['served'], claims, res['failed'][:3]))
    misplaced = {n: p for n, p in res['placement'].items() if p[0] != p[1]}
    check(len(res['placement']) == fleet.POOLS and not misplaced,
          'sharded fleet: p_shard != shard_of for %r' % misplaced)
    n_control = claims // fleet.CONTROL_EVERY
    check(len(passes) == claims // fleet.SAMPLE_EVERY + 2 * n_control,
          'sharded fleet: %d passes' % len(passes))
    check(launches == res['fir_launches'] == shards * len(passes),
          'sharded fleet: %d FIR launches in %d passes of %d shards'
          % (launches, len(passes), shards))
    edge = 0
    for k, p in enumerate(passes):
        tag = 'sharded fleet pass %d (%s)' % (k, p['kind'])
        for sid, (got, want) in enumerate(p['shards']):
            edge += check_sampler_records('%s shard %d' % (tag, sid), got,
                                          want, counts=False)[0]
        check_pass_rows(tag, p['kind'], p['row'], p['shards'])
    check(all(p['row']['n_pools'] == fleet.POOLS for p in passes
              if p['kind'] != 'health'), 'sharded fleet: a pass missed pools')
    reached = res['reached']
    check(reached['applied'] > 0 and reached['decisions'] > 0
          and reached['advisories'] > 0,
          'sharded fleet: the card samplers reached no pool: %r' % reached)
    merged = res['merged']
    check(merged['profile']['n_shards'] == shards
          and merged['wiretap']['n_shards'] == shards,
          'sharded fleet: profile_fleet / wiretap_fleet merged %d / %d '
          'shards' % (merged['profile']['n_shards'],
                      merged['wiretap']['n_shards']))
    check(merged['profile']['claims'] > 0,
          'sharded fleet: profile_fleet saw no claim')
    prof = res['profiler']
    check(prof['armed'], 'sharded fleet: the SIGPROF sampler did not arm: '
          '%s' % prof['at_start']['disabled_reason'])
    check(prof['stats']['samples'] > 0,
          'sharded fleet: the profiler took no sample: %r' % prof['stats'])
    check(prof['flamegraph'].startswith('claim;'),
          'sharded fleet: flamegraph starts %r' % prof['flamegraph'][:40])
    check(res['kang_shards'] == {'routers': [res['snapshot']]},
          'sharded fleet: GET /kang/shards differs from snapshot()')
    check(res['kang_profile'].strip() != '',
          'sharded fleet: GET /kang/profile is empty')
    lines = res['dump'].splitlines()
    head = 'fleet_router backend=thread shards=%d' % shards
    check(head in lines, 'sharded fleet: the dump lacks %r' % head)
    at = lines.index(head)
    shard_lines = lines[at + 1:at + 1 + shards]
    check([ln.split()[:2] for ln in shard_lines]
          == [['shard', str(sid)] for sid in range(shards)],
          'sharded fleet: dump shard lines %r' % shard_lines)
    pool_lines = lines[at + 1 + shards:at + 1 + shards + fleet.POOLS]
    check(sorted(ln.split()[1:] for ln in pool_lines) == sorted(
        [name, '->', 'shard', str(sid)]
        for name, (sid, _) in res['placement'].items()),
        'sharded fleet: dump pool lines differ from the placement')
    check(not res['violations'],
          'sharded fleet: loop-affinity violations %r' % res['violations'][:3])
    print('sharded fleet: %d claims over %d pools on %d shard loops served '
          '(%r per shard); %d passes agree with the CPU twins (%d row-ticks '
          'on the target boundary); %d FIR launches; %d decisions applied, '
          '%d pools hold their shard\'s last epoch; profiler %d samples; '
          'marshal sites %s; 0 affinity violations'
          % (res['served'], fleet.POOLS, shards, res['by_shard'],
             len(passes), edge, launches, reached['applied'],
             reached['decisions'], prof['stats']['samples'],
             ', '.join(res['marshals'])))
    alone = asyncio.run(fleet.run(twin_device=None))
    check(alone['served'] == claims and not alone['failed'],
          'sharded fleet without twin: %d served' % alone['served'])
    check(alone['fir_launches'] == shards * len(alone['passes']),
          'sharded fleet without twin: %d launches in %d passes'
          % (alone['fir_launches'], len(alone['passes'])))
    check(not alone['violations'],
          'sharded fleet without twin: affinity violations %r'
          % alone['violations'][:3])
    out = {'shards': shards, 'pools': fleet.POOLS, 'claims': claims,
           'concurrency': fleet.CONCURRENCY, 'passes': len(passes),
           'fir_launches': launches,
           'launches_per_pass': alone['launches_per_pass'],
           'claims_per_s_with_twin': res['claims_per_s'],
           'claims_per_s': alone['claims_per_s'],
           'ms_per_sample_pass': alone['ms_per_sample_pass'],
           'ms_per_sample_pass_with_twin': res['ms_per_sample_pass'],
           'profiler_samples': [prof['stats']['samples'],
                                alone['profiler']['stats']['samples']],
           'wall_s': alone['wall_s'],
           'phase_s': time.perf_counter() - t_phase, 'nvidia_smi': smi}
    print('sharded fleet: %.1f claims/s, %.4f ms per sample pass (host '
          'clock, ends in a device sync), %.1f FIR launches per pass, '
          'without the twin; %s' % (alone['claims_per_s'],
                                    alone['ms_per_sample_pass'],
                                    alone['launches_per_pass'], smi))
    return launches, out


def check_control_sharded(tag, got, want, equal_nan=False):
    """A sharded control step's (states, decisions, fleets) against the
    unsharded step's on the card: state, decisions and the fleet counts
    bit for bit, `mean_load` (summed in another order) to rtol 1e-5.
    With ``equal_nan``, NaN equals NaN in the same place."""
    gs, gd, gf = (unshard(t) for t in got)
    ws, wd, wf = want
    check_same(tag + ' state', gs, ws, equal_nan)
    check_same(tag + ' decisions', gd, wd, equal_nan)
    for name in ('n_pools', 'pressure', 'max_sojourn'):
        check(same(gf[name], wf[name]) if equal_nan
              else torch.equal(gf[name], wf[name]), '%s: %s' % (tag, name))
    torch.testing.assert_close(gf['mean_load'], wf['mean_load'], rtol=RTOL,
                               atol=0, equal_nan=equal_nan)


def nonfinite_rows_phase(dev, mesh):
    """Phase 18's fixed rows: one control tick over the five cases and
    one health tick over each ``lat_sum`` column, on the card, against
    the CPU, the JAX package's frozen numbers and the 4-shard step."""
    n = NONFINITE_POOLS
    inp = ctl.control_inputs(n, device=dev, **nonfinite_control_columns(
        [case for _, case in NONFINITE_CONTROL_CASES]))
    got = ctl.control_step(ctl.control_init(n, device=dev), inp)
    check_control('non-finite control rows', got, ctl.control_step(
        ctl.control_init(n, device='cpu'), cpu_copy(inp)), equal_nan=True)
    for name, want in JAX_NONFINITE_DECISIONS.items():
        check(got[1][name].tolist() == want,
              'non-finite control rows: %s %r, the JAX package %r'
              % (name, got[1][name].tolist(), want))
    sharded = ctl.make_control_step(mesh)(
        ctl.shard_control_state(ctl.control_init(n, device=dev), mesh),
        ctl.shard_control_inputs(inp, mesh))
    check_control_sharded('non-finite control rows sharded', sharded, got,
                          equal_nan=True)
    print('control rows: %s bit-identical to the CPU port, the JAX '
          "package's numbers and the %d-shard step; plan_target %s, "
          'plan_spares %s, delta %s'
          % (', '.join(name for name, _ in NONFINITE_CONTROL_CASES),
             SHARDS, *(got[1][k][:len(NONFINITE_CONTROL_CASES)].tolist()
                       for k in ('plan_target', 'plan_spares', 'delta'))))

    b = NONFINITE_BACKENDS
    mhealth = hl.make_health_step(mesh)
    for name, lat_sum in NONFINITE_LAT_SUMS:
        tag = 'non-finite health rows %s' % name
        inp = hl.health_inputs(b, device=dev,
                               **nonfinite_health_columns(lat_sum))
        got = hl.health_step(hl.health_init(b, device=dev), inp)
        check_health(tag, got, hl.health_step(
            hl.health_init(b, device='cpu'), cpu_copy(inp)), equal_nan=True)
        score = got[1]['score'].tolist()
        check(score == JAX_NONFINITE_SCORES[name] and
              not got[1]['gray'].any().item(),
              '%s: score %r, the JAX package %r'
              % (tag, score, JAX_NONFINITE_SCORES[name]))
        fleet = to_host_values({k: got[2][k]
                                for k in JAX_NONFINITE_HEALTH_FLEET})
        check(fleet == JAX_NONFINITE_HEALTH_FLEET, '%s: fleet %r, the JAX '
              'package %r' % (tag, fleet, JAX_NONFINITE_HEALTH_FLEET))
        sharded = mhealth(hl.shard_health_state(hl.health_init(
            b, device=dev), mesh), hl.shard_health_inputs(inp, mesh))
        for part, g, w in zip(('state', 'verdicts', 'fleet'), sharded, got):
            check_same('%s sharded %s' % (tag, part), unshard(g), w,
                       equal_nan=True)
        print('health rows %s: lat_sum %s, score %s, fleet %s, bit-identical '
              "to the CPU port, the JAX package's numbers and the %d-shard "
              'step' % (name, list(lat_sum), score, fleet, SHARDS))


def nonfinite_phase(dev, smi, ctl_ms_step, health_ms_step):
    """Phase 18. Returns its numbers for the summary line."""
    phase('18 non-finite inputs')
    probe = torch.tensor(RAW_CAST_PROBE, dtype=torch.float32)
    raw_card = probe.to(dev).to(torch.int32).tolist()
    print('raw cast: .to(torch.int32) of %s gives %s on the card (%s), %s '
          'on the CPU; to_int32_xla gives %s on the card'
          % (list(RAW_CAST_PROBE), raw_card, torch.cuda.get_device_name(0),
             probe.to(torch.int32).tolist(),
             to_int32_xla(probe.to(dev)).tolist()))
    vec = torch.from_numpy(cast_vector())
    check(torch.equal(to_int32_xla(vec.to(dev)).cpu(), to_int32_xla(vec)),
          'to_int32_xla on the card differs from the CPU')
    print('to_int32_xla: %d values equal on the card and the CPU'
          % vec.numel())

    mesh = Mesh([torch.device('cuda', 0)] * SHARDS, ('pools',))
    nonfinite_rows_phase(dev, mesh)

    rng = np.random.default_rng(18)
    n = LIVE_POOLS
    mctl = ctl.make_control_step(mesh)
    state = ctl.control_init(n, device=dev)
    ref = ctl.control_init(n, device='cpu')
    sharded = ctl.shard_control_state(ctl.control_init(n, device=dev), mesh)
    nan_inputs = bound_rows = 0
    for k in range(NONFINITE_TICKS):
        tag = 'non-finite control tick %d' % k
        floats = dict(
            samples=rng.uniform(0, 8, n), sojourns=rng.uniform(0, 600, n),
            filtered=rng.uniform(0, 8, n),
            target_delay=np.where(rng.random(n) < 0.33, np.inf,
                                  rng.integers(50, 800, n)),
            spares=rng.integers(0, 6, n), maximum=rng.integers(6, 20, n))
        floats = {name: with_specials(rng, col, SPECIAL_SHARE)
                  for name, col in floats.items()}
        inp = ctl.control_inputs(
            n, device=dev, active=rng.random(n) < 0.9,
            reset=rng.random(n) < 0.02, now_ms=1000.0 * (k + 1), **floats)
        got = ctl.control_step(state, inp)
        want = ctl.control_step(ref, cpu_copy(inp))
        check_control(tag, got, want, equal_nan=True)
        got_sh = mctl(sharded, ctl.shard_control_inputs(inp, mesh))
        check_control_sharded(tag + ' sharded', got_sh, got, equal_nan=True)
        state, ref, sharded = got[0], want[0], got_sh[0]
        nan_inputs += int(np.isnan(np.stack(list(floats.values())))
                          .any(0).sum())
        for name in ('plan_target', 'plan_spares', 'delta'):
            col = got[1][name]
            bound_rows += int(((col == 2 ** 31 - 1) | (col == -2 ** 31))
                              .sum())
    c_prof = profile_live._profile('control step, phase 18', [
        lambda: ctl.control_step(state, inp)] * PROFILED_STEPS)
    print('control: %d ticks at %d pools, 1%% of each float column special '
          '(%d row-ticks with a NaN input, %d decisions at an int32 '
          'bound), bit-identical to the CPU port and to the %d-shard step'
          % (NONFINITE_TICKS, n, nan_inputs, bound_rows, SHARDS))

    b = HEALTH_BACKENDS
    cols = health_example_columns(b)
    mhealth = hl.make_health_step(mesh)
    h_state = hl.health_init(b, device=dev)
    h_ref = hl.health_init(b, device='cpu')
    h_sh = hl.shard_health_state(hl.health_init(b, device=dev), mesh)
    edge = nan_ewma = 0
    for k in range(NONFINITE_TICKS):
        tag = 'non-finite health tick %d' % k
        inp = hl.health_inputs(b, device=dev, **dict(
            cols, lat_sum=with_specials(rng, cols['lat_sum'], SPECIAL_SHARE),
            now_ms=np.float32(1000.0 * (k + 1))))
        got = hl.health_step(h_state, inp)
        want = hl.health_step(h_ref, cpu_copy(inp))
        edge += check_health(tag, got, want, equal_nan=True)
        got_sh = mhealth(h_sh, hl.shard_health_inputs(inp, mesh))
        for part, g, w in zip(('state', 'verdicts', 'fleet'), got_sh, got):
            check_same('%s sharded %s' % (tag, part), unshard(g), w,
                       equal_nan=True)
        h_state, h_ref, h_sh = got[0], want[0], got_sh[0]
        nan_ewma += int(torch.isnan(got[1]['ewma_ms']).sum())
    h_prof = profile_live._profile('health step, phase 18', [
        lambda: hl.health_step(h_state, inp)] * PROFILED_STEPS)
    print('health: %d ticks at %d backends, 1%% of lat_sum special (%d '
          'backend-ticks with a NaN EWMA; %d on the score boundary), equal '
          'to the CPU port and bit-identical to the %d-shard step; n_gray %d'
          % (NONFINITE_TICKS, b, nan_ewma, edge, SHARDS,
             int(got[2]['n_gray'])))
    c_launches = c_prof['device_launches_per_tick']
    h_launches = h_prof['device_launches_per_tick']
    print('after the repair: control %.5f ms/step (phase 7), %.2f launches '
          'and %.4f ms device busy per step; health %.5f ms/step (phase 8), '
          '%.2f launches and %.4f ms device busy per step (profile_live'
          "'s count); %s"
          % (ctl_ms_step, c_launches, c_prof['device_busy_ms_per_tick'],
             health_ms_step, h_launches, h_prof['device_busy_ms_per_tick'],
             smi))
    return {'raw_cast_card': raw_card, 'control_launches': c_launches,
            'health_launches': h_launches,
            'control_busy_ms': c_prof['device_busy_ms_per_tick'],
            'health_busy_ms': h_prof['device_busy_ms_per_tick'],
            'control_ms_per_step': ctl_ms_step,
            'health_ms_per_step': health_ms_step,
            'control_nan_input_row_ticks': nan_inputs,
            'control_bound_decisions': bound_rows,
            'health_nan_ewma_backend_ticks': nan_ewma,
            'health_boundary_backend_ticks': edge}


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; the port runs on an NVIDIA GPU',
              file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    errs = []

    phase('0 device')
    kind = torch.cuda.get_device_name(0)
    smi = bench.nvidia_smi()
    print('torch %s, CUDA %s, device %s' % (torch.__version__,
                                             torch.version.cuda, kind))
    print('nvidia-smi: %s' % smi)

    phase('1 build')
    t0 = time.perf_counter()
    built = build.build_all()
    for name, info in built.items():
        print('built %s -> %s' % (name, info['path']))
        print(info['log'].strip())
    print('build seconds: %.3f' % (time.perf_counter() - t0))

    phase('2 kernel vs plain')
    gen = torch.Generator(device=dev).manual_seed(0)
    for k in KERNEL_TAPS:
        taps = fir.gen_taps(k, device=dev)
        for p in KERNEL_POOLS:
            w = torch.rand((p, k), generator=gen, device=dev) * 8.0
            got = fir.fir_apply_cuda(w, taps)
            want = fir.fir_apply_plain(w, taps)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
            errs.append(max_errs(got, want))
            print('P=%d K=%d max_abs_err=%.3e max_rel_err=%.3e'
                  % (p, k, *errs[-1]))

    phase('3 entry')
    fn, (state, inp) = entry()
    got = fn(state, inp)
    want = tel.fleet_step_plain(state, inp)
    torch.cuda.synchronize()
    errs.append(max_errs(*compare_step('entry', got, want)))
    edge = check_target('entry', got[1], want[1], inp)
    print('entry: %d pools agree; %d rows on the target boundary'
          % (ENTRY_POOLS, edge))

    phase('4 live (main path)')
    rng = np.random.default_rng(1)
    state, base = example_inputs(LIVE_POOLS, seed=1)
    ref = state._replace(windows=state.windows.clone())
    live = tel.make_live_step()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    tick_ms, edge_rows = [], 0
    # Phase 7 rides on these ticks: the control step on each tick's own
    # device tensors, and on the CPU on copies of them.
    control_step = ctl.make_control_step()
    c_state = ctl.control_init(LIVE_POOLS, device=dev)
    c_ref = ctl.control_init(LIVE_POOLS, device='cpu')
    ctl_ms = []
    fir.fir_apply_cuda.launches = 0
    for k in range(LIVE_TICKS):
        inp = tick_inputs(base, rng, k)
        start.record()
        state, out, fleet = live(state, inp)
        end.record()
        ref, r_out, r_fleet = tel.fleet_step_plain(ref, inp)
        torch.cuda.synchronize()
        tick_ms.append(start.elapsed_time(end))
        errs.append(max_errs(*compare_step(
            'live tick %d' % k, (state, out, fleet), (ref, r_out, r_fleet))))
        edge_rows += check_target('live tick %d' % k, out, r_out, inp)

        cinp = ctl.ControlInputs(
            samples=inp.samples, sojourns=inp.sojourns,
            filtered=out['filtered'], target_delay=inp.target_delay,
            spares=inp.spares, maximum=inp.maximum, active=inp.active,
            reset=inp.reset, now_ms=inp.now_ms)
        start.record()
        c_got = control_step(c_state, cinp)
        end.record()
        c_want = control_step(c_ref, cpu_copy(cinp))
        torch.cuda.synchronize()
        ctl_ms.append(start.elapsed_time(end))
        check_control('control tick %d' % k, c_got, c_want)
        c_state, c_ref = c_got[0], c_want[0]
    launches = fir.fir_apply_cuda.launches
    check(launches == LIVE_TICKS,
          'FIR kernel launched %d times in %d live ticks'
          % (launches, LIVE_TICKS))
    steady = tick_ms[1:]
    ms_tick = sum(steady) / len(steady)
    print('live: %d ticks at %d pools agree with the plain-FIR run; '
          '%d row-ticks on the target boundary' % (LIVE_TICKS, LIVE_POOLS,
                                                   edge_rows))
    print('live: fir launches %d; first tick %.4f ms; ms/tick %.4f '
          '(mean of ticks 1-%d, CUDA events); pools/s %.6g'
          % (launches, tick_ms[0], ms_tick, LIVE_TICKS - 1,
             LIVE_POOLS / (ms_tick / 1e3)))

    phase('5 scan')
    rng = np.random.default_rng(2)
    state0, base = example_inputs(SCAN_POOLS, seed=2)
    ticks = [tick_inputs(base, rng, k) for k in range(SCAN_TICKS)]
    window = tel.FleetInputs(*(torch.stack(col) for col in zip(*ticks)))
    fin, outs, fleets = tel.fleet_scan(state0, window)
    state = state0
    for t, inp in enumerate(ticks):
        state, out, fleet = tel.fleet_step(state, inp)
        for name in out:
            check(torch.equal(outs[name][t], out[name]),
                  'scan tick %d: %s differs from stepping' % (t, name))
        for name in fleet:
            check(torch.equal(fleets[name][t], fleet[name]),
                  'scan tick %d: aggregate %s differs' % (t, name))
    for a, b in zip((fin.windows, fin.now_ms, *fin.codel),
                    (state.windows, state.now_ms, *state.codel)):
        check(torch.equal(a, b), 'scan final state differs from stepping')
    torch.cuda.synchronize()
    print('scan: %d ticks at %d pools equal stepping' % (SCAN_TICKS,
                                                         SCAN_POOLS))

    phase('6 timing')
    times = {}
    for p in TIMING_POOLS:
        w = torch.rand((p, TAPS), generator=gen, device=dev) * 8.0
        taps = fir.gen_taps(TAPS, device=dev)
        iters = 200 if p <= 1 << 16 else 50
        kernel_ms = time_ms(lambda: fir.fir_apply_cuda(w, taps), iters)
        plain_ms = time_ms(lambda: fir.fir_apply_plain(w, taps), iters)
        library_ms = time_ms(lambda: torch.mv(w, taps.flip(0)), iters)
        bound_ms, bound_by = fir_bound_ms(p, TAPS)
        times[p] = dict(ms=kernel_ms, plain_ms=plain_ms,
                        library_ms=library_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
        print('P=%d K=%d kernel %.5f ms, plain %.5f ms, torch.mv %.5f ms, '
              'bound %.5f ms (%s)' % (p, TAPS, kernel_ms, plain_ms,
                                      library_ms, bound_ms, bound_by))

    phase('7 control')
    ctl_step_ms = sum(ctl_ms[1:]) / (len(ctl_ms) - 1)
    c_dec = c_got[1]
    print('control: %d steps at %d pools bit-identical to the CPU run '
          '(epoch %d, %d rows with a CoDel target, pressure %.6g)'
          % (LIVE_TICKS, LIVE_POOLS, int(c_dec['epoch']),
             int((c_dec['codel_target'] > 0).sum()),
             float(c_got[2]['pressure'])))
    print('control: first step %.4f ms; ms/step %.5f (mean of steps 1-%d, '
          'CUDA events)' % (ctl_ms[0], ctl_step_ms, LIVE_TICKS - 1))

    phase('8 health')
    cols = health_example_columns(HEALTH_BACKENDS)
    h_inp = hl.health_inputs(HEALTH_BACKENDS, device=dev, **cols)
    h_ref_inp = hl.health_inputs(HEALTH_BACKENDS, device='cpu', **cols)
    health_step = hl.make_health_step()
    h_state = hl.health_init(HEALTH_BACKENDS, device=dev)
    h_ref = hl.health_init(HEALTH_BACKENDS, device='cpu')
    h_ms, h_edge = [], 0
    for k in range(HEALTH_TICKS):
        now = torch.tensor(1000.0 * (k + 1), dtype=torch.float32)
        tick_inp = h_inp._replace(now_ms=now.to(dev))
        start.record()
        h_got = health_step(h_state, tick_inp)
        end.record()
        h_want = health_step(h_ref, h_ref_inp._replace(now_ms=now))
        torch.cuda.synchronize()
        h_ms.append(start.elapsed_time(end))
        h_edge += check_health('health tick %d' % k, h_got, h_want)
        h_state, h_ref = h_got[0], h_want[0]
    n_gray = int(h_got[2]['n_gray'])
    check(n_gray > 0, 'health: no backend judged gray in %d ticks'
          % HEALTH_TICKS)
    health_step_ms = sum(h_ms[1:]) / (len(h_ms) - 1)
    print('health: %d ticks at %d backends agree with the CPU run; '
          'n_gray %d, median score %d, MAD %d; %d backend-ticks on the '
          'score boundary' % (HEALTH_TICKS, HEALTH_BACKENDS, n_gray,
                              int(h_got[2]['median_score']),
                              int(h_got[2]['mad_score']), h_edge))
    print('health: first step %.4f ms; ms/step %.5f (mean of steps 1-%d, '
          'CUDA events)' % (h_ms[0], health_step_ms, HEALTH_TICKS - 1))

    phase('9 sampler (main path)')
    work = SamplerWorkload(SAMPLER_POOLS, SAMPLER_BACKENDS)
    on_card = FleetSampler(work.options())
    on_cpu = FleetSampler(work.options(device='cpu'))
    check(on_card.fs_device.type == 'cuda', 'sampler default is not CUDA')
    s_ms, s_edge, s_drops = [], 0, 0
    fir.fir_apply_cuda.launches = 0
    for k in range(SAMPLER_TICKS):
        work.advance()
        t0 = time.perf_counter()
        got = on_card.sample_once()
        s_ms.append((time.perf_counter() - t0) * 1e3)
        want = on_cpu.sample_once()
        edge, drops = check_sampler_records('sampler tick %d' % k, got, want)
        s_edge += edge
        s_drops += drops
    sampler_launches = fir.fir_apply_cuda.launches
    check(sampler_launches == SAMPLER_TICKS,
          'FIR kernel launched %d times in %d sampler ticks'
          % (sampler_launches, SAMPLER_TICKS))
    check(s_drops > 0, 'sampler: no CoDel drop in %d ticks' % SAMPLER_TICKS)
    check(got['health']['gray'] == ['backend-7'],
          'sampler: health judged %r gray' % (got['health']['gray'],))
    on_card.stop()
    on_cpu.stop()
    sampler_ms = sum(s_ms[1:]) / (len(s_ms) - 1)
    print('sampler: %d ticks at %d pools agree with the CPU sampler; '
          '%d drops; %d row-ticks on the target boundary; gray %s'
          % (SAMPLER_TICKS, SAMPLER_POOLS, s_drops, s_edge,
             got['health']['gray']))
    print('sampler: fir launches %d; first tick %.3f ms; wall ms/tick '
          '%.4f (mean of ticks 1-%d, host clock, ends in a device sync); '
          'pools/s %.6g' % (sampler_launches, s_ms[0], sampler_ms,
                            SAMPLER_TICKS - 1,
                            SAMPLER_POOLS / (sampler_ms / 1e3)))
    print('steps ' + json.dumps({
        'control_ms_per_step': ctl_step_ms, 'control_pools': LIVE_POOLS,
        'health_ms_per_step': health_step_ms,
        'health_backends': HEALTH_BACKENDS,
        'sampler_wall_ms_per_tick': sampler_ms,
        'sampler_pools': SAMPLER_POOLS,
        'sampler_pools_per_s': SAMPLER_POOLS / (sampler_ms / 1e3)}))

    meshed = mesh_phases(dev, start, end)
    print('mesh ' + json.dumps(meshed))

    loop = asyncio.new_event_loop()
    try:
        card, card_work, routed = router_phase(dev,
                                               loop.run_until_complete)
        print('router ' + json.dumps(routed))
        surfaces_phase(loop.run_until_complete, card, card_work)
    finally:
        loop.close()
    example_launches = examples_phase()
    bench_launches, bench_errs = bench_phase(kind, smi)
    errs.extend(bench_errs)
    fleet_launches = fleet_phase()
    nonfinite = nonfinite_phase(dev, smi, ctl_step_ms, health_step_ms)
    print('nonfinite ' + json.dumps(nonfinite))
    pool_launches, pooled = pool_fleet_phase(smi)
    print('pool_fleet ' + json.dumps(pooled))
    discovered_launches, discovered = discovered_fleet_phase(smi)
    print('discovered_fleet ' + json.dumps(discovered))
    sharded_launches, sharded = sharded_fleet_phase(smi)
    print('sharded_fleet ' + json.dumps(sharded))

    main_t = times[LIVE_POOLS]
    record = {
        'name': 'fir', 'route': 'cuda',
        'source': 'cueball_tpu_torch/csrc/fir.cu',
        'replaces': 'cueball_tpu/ops/fir.py:84',
        'launches': (launches + sampler_launches
                     + meshed['sharded_live_launches']
                     + meshed['mesh_sampler_launches']
                     + routed['launches'] + example_launches
                     + bench_launches + fleet_launches + pool_launches
                     + discovered_launches + sharded_launches),
        'launches_by_path': {
            'live_step': launches, 'sampler': sampler_launches,
            'sharded_live': meshed['sharded_live_launches'],
            'mesh_sampler': meshed['mesh_sampler_launches'],
            'router': routed['launches'], 'examples': example_launches,
            'bench': bench_launches, 'inference_fleet': fleet_launches,
            'pool_fleet': pool_launches,
            'discovered_fleet': discovered_launches,
            'sharded_fleet': sharded_launches},
        'max_abs_err': max(max(e[0] for e in errs), routed['max_abs_err']),
        'max_rel_err': max(max(e[1] for e in errs), routed['max_rel_err']),
        'ms': main_t['ms'], 'kernel_ms': main_t['ms'],
        'plain_ms': main_t['plain_ms'], 'bound_ms': main_t['bound_ms'],
        'bound_by': main_t['bound_by'],
        'library_ms': main_t['library_ms'],
        'library_call': 'torch.mv(windows, taps.flip(0))',
        'shape': [LIVE_POOLS, TAPS],
        'by_pools': {str(p): t for p, t in times.items()},
        'live_ms_per_tick': ms_tick,
        'live_pools_per_s': LIVE_POOLS / (ms_tick / 1e3),
    }
    print(json.dumps({'kernels': [record]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print('chip_smoke: FAIL: %s' % e, file=sys.stderr)
        sys.exit(1)
