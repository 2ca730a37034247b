"""The port's bench: the telemetry stages of the JAX package's
``bench.py`` (``bench_telemetry_stages`` and the guarded child that runs
them), stage for stage and at the same shapes, on the CUDA card.

    python -m cueball_tpu_torch.bench [--out FILE] [--sizes-small]

prints one JSON object: every stage's fields, the stages that landed,
the card's name and power limit (from ``nvidia-smi``), the torch and
CUDA versions and :func:`code_hash`. The stages, cheapest first:

- ``device``: the card's name, the ``nvidia-smi`` name and power limit;
- ``dispatch_floor``: per-call time of a chained trivial op, the floor
  no step goes below;
- ``step_small`` / ``step_live``: the live step (``make_live_step``),
  state fed back, at 65,536 and 1,048,576 pools; ``step_live`` also
  records the ms/tick of each of its rounds (the spread in one run);
- ``fleet_sweep``: the live step and the control step over
  ``CONTROL_SIZES``;
- ``step_plain`` / ``step_kernel``: ``fleet_step_plain`` and
  ``fleet_step_cuda`` on the same arguments, and whether the default
  ``fleet_step`` launches the kernel;
- ``scan``: ``fleet_scan`` over a 64-tick window;
- ``tick_cost_N``: ``FleetSampler.sample_once`` over N synthetic pools,
  the incremental gather and the full-fleet gather timed on their own;
- ``health_sweep``: the health step over ``HEALTH_SIZES``.

Every stage but ``device`` also records its FIR kernel launches
(``fir_launches_<stage>``), so a record shows which stages measured the
kernel. Times are host-clock seconds between two device
synchronizations, so they hold the launches and the device work.

The stages run in a child process that appends each stage to a
progress file as it lands (:func:`run_guarded`): a run killed by its
timeout keeps every stage that landed before. There is no CPU
fallback, unlike the JAX bench (whose stages run on the host CPU when no
chip answers): the stages run on the card unless the caller passes
``device='cpu'``, and without a card the default raises.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import host, utils
from ._device import resolve_device
from .entry import SyntheticPool, example_inputs
from .monitor import PoolMonitor
from .ops import fir
from .parallel import control as ctl
from .parallel import health as hl
from .parallel.sampler import FleetSampler
from .parallel.telemetry import (FleetInputs, fleet_scan, fleet_step,
                                 fleet_step_cuda, fleet_step_plain,
                                 make_live_step)

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent

# The JAX bench's shapes, copied: the live step's fleet, the small
# stage, the sampler tick sizes, and the control and health sweeps.
TELEM_POOLS = 1 << 20
TELEM_SMALL = 1 << 16
TELEM_TICK_SIZES = (1024, 10240, 102400)
CONTROL_SIZES = (10_240, 102_400, 1_048_576)
HEALTH_SIZES = (10_240, 102_400)
SCAN_TICKS = 64
GATHER_CHURN = 128   # dirty rows per timed incremental gather
LIVE_ROUNDS = 5      # step_live's 50 ticks, timed in 5 rounds of 10
PROBE_POOLS = 8      # the fleet that default_is_kernel steps


#: The code the numbers measure, under the package: the kernels and
#: their build, the steps, the sampler and its monitor, the inputs.
_CODE = ('ops', 'csrc', 'kernels', 'parallel', 'monitor.py', 'entry.py')


def code_hash(package: Path | str = PACKAGE) -> str:
    """Content hash of the measured code under ``package`` (the
    Python files of ``ops``, ``kernels`` and ``parallel``, every source
    in ``csrc``, ``monitor.py`` and ``entry.py``) and of the stages'
    shapes. A kernel or step edit changes it, so a record cannot
    outlive the code it measured."""
    package = Path(package)
    paths = []
    for rel in _CODE:
        p = package / rel
        if p.is_dir():
            paths.extend(sorted(f for f in p.iterdir() if f.is_file() and
                                (rel == 'csrc' or f.suffix == '.py')))
        else:
            paths.append(p)
    h = hashlib.sha256()
    for p in paths:
        h.update(p.relative_to(package).as_posix().encode())
        h.update(p.read_bytes())
    h.update(repr((TELEM_POOLS, TELEM_SMALL, TELEM_TICK_SIZES,
                   CONTROL_SIZES, HEALTH_SIZES, SCAN_TICKS)).encode())
    return h.hexdigest()[:16]


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def device_record(dev: torch.device) -> dict:
    """The ``device`` stage: on the card its name and the nvidia-smi
    line (which must answer); on the CPU neither."""
    rec = {'device': str(dev), 'torch': torch.__version__,
           'cuda': torch.version.cuda, 'device_name': None,
           'nvidia_smi': None, 'power_limit': None}
    if dev.type == 'cuda':
        rec['device_name'] = torch.cuda.get_device_name(dev)
        rec['nvidia_smi'] = nvidia_smi()
        rec['power_limit'] = rec['nvidia_smi'].rpartition(',')[2].strip()
    return rec


def _sync(dev: torch.device) -> None:
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _seconds(fn, iters: int, dev: torch.device) -> float:
    """Seconds for ``iters`` calls of ``fn``, from a synchronized device
    to a synchronized device."""
    _sync(dev)
    t0 = utils.perf_seconds()
    for _ in range(iters):
        fn()
    _sync(dev)
    return utils.perf_seconds() - t0


def default_is_kernel(dev: torch.device) -> bool:
    """Whether the default ``fleet_step`` launches the FIR kernel for
    tensors on ``dev``: observed, by the kernel's launch counter."""
    state, inp = example_inputs(PROBE_POOLS, device=dev)
    before = fir.fir_apply_cuda.launches
    fleet_step(state, inp)
    _sync(dev)
    return fir.fir_apply_cuda.launches > before


def _live_ms(live, n: int, iters: int, rounds: int, dev) -> list:
    """ms/tick of the live step ``live`` at ``n`` pools, state fed
    back, for each of ``rounds`` rounds of ``iters`` ticks (after one
    tick that builds the spare ring)."""
    state, inp = example_inputs(n, device=dev)
    box = [live(state, inp)[0]]

    def tick():
        box[0] = live(box[0], inp)[0]
    return [_seconds(tick, iters, dev) / iters * 1e3 for _ in range(rounds)]


def _fleet_sweeps(sizes, dev, cap) -> dict:
    """pools/s of the live step and of the control step at each size,
    on the JAX bench's inputs: loads cycling 0..7, sojourns 0..699
    against a 500 ms CoDel target, so both of the control law's
    branches stay live."""
    live = make_live_step()
    cstep = ctl.make_control_step()
    telem, ctrl = {}, {}
    for n in sizes:
        iters = cap(max(10, min(100, 4_000_000 // n)))
        telem[str(n)] = n / (_live_ms(live, n, iters, 1, dev)[0] / 1e3)
        idx = np.arange(n, dtype=np.float32)
        cinp = ctl.control_inputs(
            n, device=dev, samples=idx % 8.0, sojourns=idx % 700.0,
            filtered=(idx % 8.0) * np.float32(0.9), target_delay=500.0,
            spares=2.0, active=True, now_ms=1000.0)
        box = [cstep(ctl.control_init(n, device=dev), cinp)[0]]

        def step():
            box[0] = cstep(box[0], cinp)[0]
        ctrl[str(n)] = n * iters / _seconds(step, iters, dev)
    return {'telemetry_pools_per_sec_sweep': telem,
            'control_step_pools_per_sec': ctrl}


def _health_inputs(n: int, dev) -> hl.HealthInputs:
    """The JAX bench's health sweep inputs: latencies cycling 1..16 ms,
    ten claims a backend, an error on every 50th, row 0 not
    eligible."""
    idx = np.arange(n)
    lat_ms = (1.0 + idx % 16).astype(np.float32)
    bucket = np.minimum(
        (np.log2(np.float32(1.0) + lat_ms) * hl.BUCKET_SCALE).astype(
            np.int32), hl.LAT_BINS - 1)
    one_hot = np.zeros((n, hl.LAT_BINS), np.int32)
    one_hot[idx, bucket] = 1
    return hl.health_inputs(
        n, device=dev, lat_sum=lat_ms * np.float32(10.0),
        lat_count=np.full(n, 10, np.int32), lat_buckets=one_hot * 10,
        claim_buckets=one_hot * 10, errors=(idx % 50 == 0).astype(np.int32),
        active=np.ones(n, bool), eligible=idx > 0, now_ms=1000.0)


def _health_sweeps(sizes, dev, cap) -> dict:
    step = hl.make_health_step()
    rate, us = {}, {}
    for n in sizes:
        iters = cap(max(10, min(100, 4_000_000 // n)))
        inp = _health_inputs(n, dev)
        box = [step(hl.health_init(n, device=dev), inp)[0]]

        def tick():
            box[0] = step(box[0], inp)[0]
        dt = _seconds(tick, iters, dev)
        rate[str(n)] = n * iters / dt
        us[str(n)] = 1e6 * dt / iters
    return {'health_step_pools_per_sec': rate, 'health_step_us': us}


def _measure_tick_cost(n: int, dev, cap) -> tuple:
    """(tick_us, gather_us, gather_full_us) of one FleetSampler over
    ``n`` synthetic pools on the port's own pool monitor: a tick with
    1/97 of the pools changing load; the incremental gather at a fixed
    churn of min(GATHER_CHURN, n) dirty rows; the full walk of every
    pool, the O(fleet) oracle."""
    mon = PoolMonitor()
    fleet = [SyntheticPool(i) for i in range(n)]
    for p in fleet:
        mon.register_pool(p)
    s = FleetSampler({'monitor': mon, 'capacity': n, 'device': dev})
    try:
        s.sample_once()                  # allocates the state
        s.sample_once()                  # warms the transfer cache
        iters = cap(5)
        k = [0]

        def tick():
            k[0] += 1
            for p in fleet[::97]:        # loads move between ticks
                p.set_load(float((p.load + k[0]) % 8))
            s.sample_once()
        tick_us = _seconds(tick, iters, dev) / iters * 1e6

        churn = min(GATHER_CHURN, n)
        g_iters = cap(20)
        stride = max(1, n // churn)
        g = [0]

        def gather():
            # The same pools go dirty each round, stepping through the
            # fleet so that successive rounds touch other rows.
            for p in fleet[g[0] % stride::stride][:churn]:
                p.set_load(float((p.load + 1) % 8))
            g[0] += 1
            s.gather_once()
        gather_us = _seconds(gather, g_iters, dev) / g_iters * 1e6

        now = host.current_millis()
        t0 = utils.perf_seconds()
        for p in fleet:
            FleetSampler.gather_pool(p, now)
        gather_full_us = (utils.perf_seconds() - t0) * 1e6
    finally:
        s.stop()
    return tick_us, gather_us, gather_full_us


def sizes_up_to(pools: int, sizes) -> tuple:
    """The protocol's ``sizes`` up to ``pools``, or ``(pools,)`` when
    none is: how a fleet smaller than the protocol's caps the stepped
    and swept sizes, as in the JAX bench."""
    return tuple(s for s in sizes if s <= pools) or (pools,)


def _dispatch_floor(run) -> dict:
    box = [torch.zeros((8,), dtype=torch.float32, device=run.dev) + 1.0]

    def tiny():
        box[0] = box[0] + 1.0
    iters = run.cap(200)
    return {'dispatch_floor_us': _seconds(tiny, iters, run.dev) / iters * 1e6}


def _step_small(run) -> dict:
    n = min(TELEM_SMALL, run.pools)
    ms = _live_ms(run.live, n, run.cap(100), 1, run.dev)[0]
    return {'small_pools': n, 'small_pools_per_sec': n / (ms / 1e3)}


def _step_live(run) -> dict:
    rounds = _live_ms(run.live, run.pools, run.cap(50 // LIVE_ROUNDS),
                      LIVE_ROUNDS, run.dev)
    return {'pools': run.pools, 'live_ms_rounds': rounds,
            'pools_per_sec_live':
                run.pools / (sum(rounds) / len(rounds) / 1e3)}


def _fleet_sweep(run) -> dict:
    return _fleet_sweeps(sizes_up_to(run.pools, CONTROL_SIZES), run.dev,
                         run.cap)


def _step_inputs(run) -> tuple:
    """The (state, inputs) at the full fleet that step_plain,
    step_kernel and scan share: ``example_inputs(pools)``."""
    if run.step_inputs is None:
        run.step_inputs = example_inputs(run.pools, device=run.dev)
    return run.step_inputs


def _step_rate(run, step) -> float:
    state, inp = _step_inputs(run)
    step(state, inp)
    iters = run.cap(20)
    return run.pools * iters / _seconds(lambda: step(state, inp), iters,
                                        run.dev)


def _step_plain(run) -> dict:
    return {'pools_per_sec_plain': _step_rate(run, fleet_step_plain)}


def _step_kernel(run) -> dict:
    return {'pools_per_sec_kernel': (_step_rate(run, fleet_step_cuda)
                                     if run.dev.type == 'cuda' else None),
            'default_is_kernel': default_is_kernel(run.dev)}


def _scan(run) -> dict:
    """The offline replay: one fleet_scan over a 64-tick window. The
    last stage on the full fleet: it lets go of the shared inputs."""
    state, inp = _step_inputs(run)
    run.step_inputs = None
    window = FleetInputs(*(a.expand((SCAN_TICKS,) + a.shape) for a in inp))
    window = window._replace(now_ms=inp.now_ms + 100.0 * torch.arange(
        SCAN_TICKS, dtype=torch.float32, device=run.dev))
    fleet_scan(state, window)
    iters = run.cap(20)
    return {'pools_per_sec_scan': run.pools * SCAN_TICKS * iters / _seconds(
        lambda: fleet_scan(state, window), iters, run.dev)}


def _tick_cost(n: int, run) -> dict:
    tick_us, gather_us, gather_full_us = _measure_tick_cost(n, run.dev,
                                                            run.cap)
    return {'tick_us_%d' % n: tick_us, 'gather_us_%d' % n: gather_us,
            'gather_full_us_%d' % n: gather_full_us}


def _health_sweep(run) -> dict:
    return _health_sweeps(sizes_up_to(run.pools, HEALTH_SIZES), run.dev,
                          run.cap)


def stages(pools: int = TELEM_POOLS) -> list:
    """Every stage :func:`run_stages` lands for ``pools``, in order, as
    ``(name, fn)``; ``fn(run)`` returns the stage's fields."""
    ticks = sizes_up_to(pools, TELEM_TICK_SIZES)
    return ([('device', lambda run: device_record(run.dev)),
             ('dispatch_floor', _dispatch_floor),
             ('step_small', _step_small), ('step_live', _step_live),
             ('fleet_sweep', _fleet_sweep), ('step_plain', _step_plain),
             ('step_kernel', _step_kernel), ('scan', _scan),
             ('tick_sizes', lambda run: {'tick_sizes': list(ticks)})]
            + [('tick_cost_%d' % n, functools.partial(_tick_cost, n))
               for n in ticks]
            + [('health_sweep', _health_sweep)])


def stage_names(pools: int = TELEM_POOLS) -> list:
    """The stages :func:`run_stages` lands for ``pools``, in order."""
    return [name for name, _ in stages(pools)]


def step_pools(pools: int = TELEM_POOLS) -> list:
    """Every fleet size at which the stages for ``pools`` step the
    telemetry, so every shape at which they launch the FIR kernel."""
    return sorted({PROBE_POOLS, min(TELEM_SMALL, pools), pools,
                   *sizes_up_to(pools, CONTROL_SIZES),
                   *sizes_up_to(pools, TELEM_TICK_SIZES)})


def run_stages(emit, device=None, pools: int = TELEM_POOLS,
               max_iters: int | None = None) -> None:
    """Run every stage on ``device`` (default: the card, which must
    exist) for a fleet of ``pools``, calling ``emit(dict)`` the moment
    each lands, with its name under ``'stage'``. The small stage, the
    sweeps and the tick sizes keep the protocol's sizes up to
    ``pools``; ``max_iters`` caps every timed loop (the protocol's
    counts when None)."""
    dev = resolve_device(device)

    def cap(iters: int) -> int:
        return iters if max_iters is None else max(1, min(iters, max_iters))

    run = SimpleNamespace(dev=dev, pools=pools, cap=cap,
                          live=make_live_step(), step_inputs=None)
    mark = fir.fir_apply_cuda.launches
    for stage, fn in stages(pools):
        fields = fn(run)
        _sync(dev)
        now = fir.fir_apply_cuda.launches
        if stage != 'device':
            fields['fir_launches_' + stage] = now - mark
        mark = now
        emit(dict(fields, stage=stage))


def bad_rates(record: dict) -> list:
    """The names of a stage record's rates and times (sweeps as
    ``<name>_<size>``, the live rounds as ``live_ms_rounds_<i>``) that
    are not finite and positive; None counts as bad."""
    vals = {}
    for k, v in record.items():
        if isinstance(v, dict) and ('per_sec' in k or k.endswith('_us')):
            vals.update({'%s_%s' % (k, n): x for n, x in v.items()})
        elif k == 'live_ms_rounds':
            vals.update({'%s_%d' % (k, i): x for i, x in enumerate(v)})
        elif 'per_sec' in k or k.endswith('_us') or '_us_' in k:
            vals[k] = v
    return sorted(k for k, v in vals.items()
                  if v is None or not math.isfinite(v) or v <= 0)


def read_progress(path) -> tuple:
    """(stage names, merged fields) of the stages a progress file holds.
    A last line cut short by a kill is ignored."""
    stages, acc = [], {}
    try:
        with open(path, encoding='utf-8') as f:
            for line in f:
                try:
                    d = json.loads(line)
                except ValueError:
                    continue
                stages.append(d.pop('stage', None))
                acc.update(d)
    except OSError:
        pass
    return stages, acc


def child_main(progress, device, **sizes) -> None:
    """The child process: run the stages (``pools`` and ``max_iters``
    in ``sizes`` as for :func:`run_stages`), appending each to
    ``progress`` as it lands, then print the merged fields."""
    acc = {}
    with open(progress, 'a', encoding='utf-8') as pf:
        def emit(stage: dict) -> None:
            acc.update({k: v for k, v in stage.items() if k != 'stage'})
            pf.write(json.dumps(stage) + '\n')
            pf.flush()
        run_stages(emit, device=device, **sizes)
    print(json.dumps(acc))


def run_guarded(timeout_s: float = 900.0, device=None,
                pools: int = TELEM_POOLS) -> dict:
    """Run the stages for ``pools`` in a child process that the timeout
    kills, and read back every stage that landed. Returns the merged
    fields with ``stages_completed``, ``code_hash`` and, when the child
    failed or was killed, ``error``. ``device`` defaults to the card;
    without one this raises before any child starts."""
    dev = resolve_device(device)
    fd, progress = tempfile.mkstemp(prefix='torch_bench_', suffix='.jsonl')
    os.close(fd)
    cmd = [sys.executable, '-m', 'cueball_tpu_torch.bench', '--child',
           progress, '--device', str(dev), '--pools', str(pools)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, (str(ROOT), os.environ.get('PYTHONPATH')))))
    err = None
    try:
        r = subprocess.run(cmd, cwd=str(ROOT), env=env, capture_output=True,
                           text=True, timeout=timeout_s)
        if r.returncode != 0:
            err = 'bench child failed: %s' % (
                r.stderr.strip().splitlines()[-1] if r.stderr.strip()
                else 'exit %d' % r.returncode)
    except subprocess.TimeoutExpired:
        err = 'bench child killed after %gs' % timeout_s
    stages, acc = read_progress(progress)
    os.unlink(progress)
    acc['stages_completed'] = stages
    acc['code_hash'] = code_hash()
    if err is not None:
        acc['error'] = err
        print('bench: %s; %d stage(s) landed before that'
              % (err, len(stages)), file=sys.stderr)
    return acc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', help='also write the JSON object here')
    ap.add_argument('--sizes-small', action='store_true',
                    help='65,536 pools: one sweep size, ticks over 1024 '
                         'and 10240 pools')
    ap.add_argument('--device', default=None,
                    help='torch device (default: the CUDA card)')
    ap.add_argument('--child', metavar='PROGRESS', help=argparse.SUPPRESS)
    ap.add_argument('--pools', type=int, default=TELEM_POOLS,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child_main(args.child, args.device, pools=args.pools)
        return 0
    pools = TELEM_SMALL if args.sizes_small else TELEM_POOLS
    rec = run_guarded(device=args.device, pools=pools)
    text = json.dumps(rec, sort_keys=True)
    if args.out:
        Path(args.out).write_text(text + '\n', encoding='utf-8')
    print(text)
    complete = rec['stages_completed'] == stage_names(pools)
    return 0 if complete and 'error' not in rec else 1


if __name__ == '__main__':
    sys.exit(main())
