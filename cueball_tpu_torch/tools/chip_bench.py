"""Capture ``BENCH_H100.json`` from the CUDA card, with a probe log:
the port's counterpart of the JAX package's ``tools/chip_bench.py``.

1. probe the card in a subprocess with a hard timeout:
   ``torch.cuda.is_available()``, the device name, and the name and
   power limit from ``nvidia-smi``;
2. only on a healthy probe, run the port bench's stages in its guarded
   child (``cueball_tpu_torch.bench.run_guarded``);
3. write the artifact, with the card's name and power limit, the torch
   and CUDA versions and the bench's ``code_hash``, only when every
   needed stage landed: a partial run is logged, not published;
4. append every attempt, healthy or not, to the probe log.

Usage: python -m cueball_tpu_torch.tools.chip_bench [--timeout S]
           [--probe-timeout S] [--out FILE] [--log FILE] [--dry]
"""

from __future__ import annotations

import argparse
import datetime
import json
import subprocess
import sys

from .. import bench, utils

#: The default artifact and probe log, at the root of the checkout.
ARTIFACT = bench.ROOT / 'BENCH_H100.json'
PROBE_LOG = bench.ROOT / 'CHIP_PROBE_H100.md'

#: The fields an artifact must carry, besides one ``tick_us_<N>``.
NEEDED = ('pools_per_sec_live', 'pools_per_sec_plain',
          'pools_per_sec_kernel', 'pools_per_sec_scan', 'dispatch_floor_us')

_PROBE = ('import torch\n'
          'ok = torch.cuda.is_available()\n'
          'print("CUDA=%d" % ok)\n'
          'if ok:\n'
          '    print("DEV=%s" % torch.cuda.get_device_name(0))\n')


def _utc_now() -> datetime.datetime:
    return datetime.datetime.fromtimestamp(utils.wall_time(),
                                           datetime.timezone.utc)


def log_line(path, text: str) -> None:
    stamp = _utc_now().isoformat(timespec='seconds')
    with open(path, 'a', encoding='utf-8') as f:
        f.write('- %s %s\n' % (stamp, text))
    print('%s %s' % (stamp, text))


def probe(timeout_s: float) -> dict:
    """``{'device': name, 'nvidia_smi': line}`` when the card answers
    within the timeout, else ``{'error': why}``."""
    try:
        r = subprocess.run([sys.executable, '-c', _PROBE],
                           capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return {'error': 'probe timed out after %gs' % timeout_s}
    lines = dict(ln.split('=', 1) for ln in r.stdout.splitlines()
                 if '=' in ln)
    if r.returncode != 0 or lines.get('CUDA') != '1':
        return {'error': 'no CUDA device (exit %d)' % r.returncode}
    try:
        smi = bench.nvidia_smi()
    except (OSError, subprocess.SubprocessError) as e:
        return {'error': 'nvidia-smi did not answer: %s' % e}
    return {'device': lines.get('DEV'), 'nvidia_smi': smi}


def missing_stages(telem: dict) -> list:
    """The needed fields the record lacks (None counts as lacking), plus
    ``tick_us_*`` when no tick size landed."""
    out = [k for k in NEEDED if telem.get(k) is None]
    if not any(k.startswith('tick_us_') for k in telem):
        out.append('tick_us_*')
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--timeout', type=float, default=900.0,
                    help='seconds before the bench child is killed')
    ap.add_argument('--probe-timeout', type=float, default=75.0)
    ap.add_argument('--out', default=str(ARTIFACT))
    ap.add_argument('--log', default=str(PROBE_LOG))
    ap.add_argument('--dry', action='store_true',
                    help='probe only; no bench, no artifact')
    args = ap.parse_args(argv)

    card = probe(args.probe_timeout)
    if 'error' in card:
        log_line(args.log, 'probe: FAILED (%s)' % card['error'])
        return 1
    log_line(args.log, 'probe: healthy (%s; nvidia-smi: %s)'
             % (card['device'], card['nvidia_smi']))
    if args.dry:
        return 0

    telem = bench.run_guarded(args.timeout, 'cuda')
    stages = telem.get('stages_completed') or []
    missing = missing_stages(telem)
    if missing or telem.get('error') is not None:
        log_line(args.log, 'capture: INCOMPLETE (stages: %s; missing: %s; '
                 'error: %s)' % (','.join(filter(None, stages)),
                                 ','.join(missing), telem.get('error')))
        return 1

    protocol = (
        'cueball_tpu_torch.bench.run_stages: %d-pool fleet; live = '
        'make_live_step, state fed back (the FleetSampler tick form); '
        'plain/kernel = fleet_step_plain/fleet_step_cuda on the same '
        'arguments; scan = fleet_scan over %d ticks; tick_cost = wall '
        'us per FleetSampler.sample_once over synthetic pools; every '
        'time from a synchronized card to a synchronized card'
        % (telem['pools'], bench.SCAN_TICKS))
    art = dict(telem, artifact='BENCH_H100', date=_utc_now().isoformat(),
               protocol=protocol)
    with open(args.out, 'w', encoding='utf-8') as f:
        json.dump(art, f, indent=1, sort_keys=True)
        f.write('\n')
    log_line(args.log, 'capture: OK -> %s (%s, %s; live %.6g plain %.6g '
             'kernel %.6g scan %.6g pools/s; floor %.6g us; code_hash %s)'
             % (args.out, art['device_name'], art['power_limit'],
                art['pools_per_sec_live'], art['pools_per_sec_plain'],
                art['pools_per_sec_kernel'], art['pools_per_sec_scan'],
                art['dispatch_floor_us'], art['code_hash']))
    return 0


if __name__ == '__main__':
    sys.exit(main())
