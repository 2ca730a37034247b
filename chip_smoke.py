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
   PyTorch call computing the same function) beside the card's bound.

Then one ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1
and prints no result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from cueball_tpu_torch import convert
from cueball_tpu_torch.entry import entry, example_inputs, tick_inputs
from cueball_tpu_torch.kernels import build
from cueball_tpu_torch.ops import fir
from cueball_tpu_torch.parallel import telemetry as tel

RTOL = ATOL = 1e-5          # the tolerance of the multichip dryrun
ENTRY_POOLS = 1024
LIVE_POOLS = 1 << 20
LIVE_TICKS = 50
SCAN_POOLS, SCAN_TICKS = 1 << 16, 64
KERNEL_POOLS = (1, 255, 256, 300, 1 << 16, 1 << 20)
KERNEL_TAPS = (128, 97)
TIMING_POOLS = (ENTRY_POOLS, LIVE_POOLS)
TAPS = 128
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


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
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
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

    main_t = times[LIVE_POOLS]
    record = {
        'name': 'fir', 'route': 'cuda',
        'source': 'cueball_tpu_torch/csrc/fir.cu',
        'replaces': 'cueball_tpu/ops/fir.py:84',
        'launches': launches,
        'max_abs_err': max(e[0] for e in errs),
        'max_rel_err': max(e[1] for e in errs),
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
