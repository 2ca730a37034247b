"""Run one cell of the benchmark once, on the card:

    python3 -m benchmark.run --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace
1`` a ``breakdown``, and last ``compared``: every number the
comparison with the reference read, beside its limit. The same numbers
are the last lines of standard error. Without a CUDA card, or with
fewer cards than the cell asks for, it exits 2 and prints no result;
if JAX or the JAX package was loaded, it exits 3 and prints none.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import spec  # noqa: E402
from .compare import judge  # noqa: E402
from .isolation import forbidden_modules  # noqa: E402


def _caches() -> None:
    """Every compiler cache at a fixed place inside the checkout."""
    build = spec.ROOT / 'build'
    os.environ.setdefault('TRITON_CACHE_DIR', str(build / 'triton_cache'))
    os.environ.setdefault('TORCH_EXTENSIONS_DIR',
                          str(build / 'torch_extensions'))
    os.environ.setdefault('CUDA_CACHE_PATH', str(build / 'cuda_cache'))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _finite(x):
    """A reading for JSON: a non-finite float as its name."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def result_line(cell, res: dict, trace: bool) -> tuple:
    """(result object, stderr lines) of one run."""
    correct, rows = judge(res['readings'], cell.limits)
    device = {'platform': 'gpu', 'kind': res['kind'], 'count': cell.chips,
              'memory_peak_bytes': int(res['peak'])}
    line = {'correct': bool(correct), 'attempted': int(res['attempted']),
            'failed': int(res['failed']), 'metrics': res['metrics'],
            'device': device}
    summary = res['summary']
    if trace and summary is not None:
        device['busy_s'] = summary.busy_s
        device['window_s'] = summary.window_s
        line['breakdown'] = {'device_ops': summary.device_ops,
                             'idle_gaps': summary.idle_gaps}
    line['compared'] = {name: {'value': _finite(value), 'limit': limit}
                        for name, value, limit in rows}
    lines = ['compared %s %r limit %r' % row for row in rows]
    return line, lines


def main(argv=None) -> int:
    args = parse(argv)
    _caches()
    import torch

    from .harness import run_cell

    cell = spec.Cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print('benchmark: %s needs %d CUDA card(s); found %d'
              % (cell.name, cell.chips,
                 torch.cuda.device_count() if torch.cuda.is_available()
                 else 0), file=sys.stderr)
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), 'cuda',
                   T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print('benchmark: forbidden modules loaded: %s' % ', '.join(bad),
              file=sys.stderr)
        return 3
    line, lines = result_line(cell, res, bool(args.trace))
    print('seconds: ' + ', '.join('%s %.3f' % kv for kv in
                                   res['parts'].items()), file=sys.stderr)
    sys.stderr.write('\n'.join(lines) + '\n')
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
