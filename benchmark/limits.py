"""The readings that the limits of a cell are set from, on the card:

    python3 -m benchmark.limits --workload <cell> --seeds 1,2,3 \
        --seconds 5 [--out limits-<cell>.jsonl]

For each seed, in one process, it runs the cell's set-up and a short
window at the cell's own size and load, then compares the program's
ticks with the reference (the lower reading of every number) and the
reference computed one precision step lower, standing in the program's
place, with the reference (the control: the upper reading). One JSON
line per seed. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--seconds', type=float, default=5.0)
    p.add_argument('--device', default='cuda')
    p.add_argument('--out')
    args = p.parse_args(argv)
    from . import run
    run._caches()
    import torch

    from . import spec
    from .harness import run_cell

    if args.device == 'cuda' and not torch.cuda.is_available():
        print('limits: no CUDA card', file=sys.stderr)
        return 2
    cell = spec.Cell(args.workload)
    out = open(args.out, 'a') if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(',')):
            res = run_cell(cell, seed, args.seconds, False, args.device,
                           time.perf_counter(), control=True)
            line = json.dumps({
                'workload': cell.name, 'seed': seed, 'kind': res['kind'],
                'program': res['readings'], 'control': res['control'],
                'metrics': {k: v['value'] for k, v in res['metrics'].items()},
                'attempted': res['attempted'], 'failed': res['failed']})
            print(line, flush=True)
            if out is not None:
                out.write(line + '\n')
                out.flush()
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
