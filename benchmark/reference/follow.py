"""The reference fleet runtime: the live, control and health steps of
``steps`` carried tick after tick over one fleet's input columns, as a
deployment's sampler carries them. It publishes each tick as host
numbers, in the shape the comparison reads."""

from __future__ import annotations

import numpy as np
import torch

from . import steps
from .backends import REGISTRY_ROWS, BackendColumns

#: The live step's [P] float input columns, then its bool ones.
FLOAT_INPUTS = ('samples', 'sojourns', 'target_delay', 'spares', 'maximum',
                'retry_delay', 'retry_max_delay', 'retry_attempt',
                'n_retrying')
BOOL_INPUTS = ('active', 'reset')


class Follower:
    """One reference fleet of ``capacity`` rows on ``device``. Feed it
    each tick's inputs with :meth:`tick`; feed each finished claim the
    health step should see to :attr:`backends` before the tick that
    drains it. ``initial_keys`` are the backend keys the deployment's
    registry held before the fleet started, row order: in a process of
    its own, only the unattributed key."""

    def __init__(self, capacity: int, taps: int, device, lowp: bool = False,
                 backend_rows: int = REGISTRY_ROWS + 1,
                 initial_keys=('',)):
        self.device = torch.device(device)
        self.lowp = lowp
        self.live = steps.live_init(capacity, taps, self.device)
        self.ctrl = steps.control_init(capacity, self.device)
        self.health = steps.health_init(backend_rows, self.device)
        self.backends = BackendColumns(backend_rows)
        for key in initial_keys:
            if key:
                self.backends.keys.append(key)
                self.backends.index[key] = len(self.backends.keys) - 1

    def rebase(self, shift: float) -> None:
        self.live = steps.rebase(self.live, shift)

    def tick(self, cols: dict, now_ms: float, control: bool = True,
             health: bool = True) -> dict:
        """One tick over host ``cols`` ([P] numpy columns named as
        FLOAT_INPUTS and BOOL_INPUTS) at the epoch-relative clock
        ``now_ms``. Returns the tick's outputs as numpy and Python
        numbers."""
        dev = self.device
        inp = {k: torch.as_tensor(np.asarray(cols[k], np.float32), device=dev)
               for k in FLOAT_INPUTS}
        inp.update({k: torch.as_tensor(np.asarray(cols[k], bool), device=dev)
                    for k in BOOL_INPUTS})
        now = torch.tensor(np.float32(now_ms), dtype=torch.float32, device=dev)
        self.live, out, fleet = steps.live_step(self.live, inp, now, self.lowp)
        rec = {'out': {k: v.cpu().numpy() for k, v in out.items()},
               'fleet': {k: float(v) for k, v in fleet.items()}}
        if control:
            self.ctrl, dec, cfleet, epoch = steps.control_step(
                self.ctrl, inp, out['filtered'], self.lowp)
            rec['control'] = {
                'decisions': {k: v.cpu().numpy() for k, v in dec.items()},
                'fleet': cfleet, 'epoch': epoch}
        if health:
            self.health, ver, hfleet, epoch = steps.health_step(
                self.health, self.backends.drain(dev), self.lowp)
            rec['health'] = self._publish(ver, hfleet, epoch)
        return rec

    def _publish(self, ver: dict, fleet: dict, epoch: int) -> dict:
        v = {k: x.cpu().numpy() for k, x in ver.items()}
        backends = {}
        for row in np.nonzero(v['gray'] | (v['ewma'] > 0.0))[0]:
            key = self.backends.key_for(int(row))
            if key is None:
                continue
            backends[key or '(unattributed)'] = {
                'gray': bool(v['gray'][row]), 'z': float(v['z'][row]),
                'score': int(v['score'][row]),
                'ewma_ms': float(v['ewma'][row])}
        return {'epoch': epoch, 'backends': backends,
                'gray': sorted(k for k, b in backends.items() if b['gray']),
                'fleet': fleet}


class _Rows:
    """A reference tick's columns under the names a sampler's row view
    gives them."""

    def __init__(self, cols: dict, out: dict):
        self.tp_cols = cols
        self.tp_out = out


def as_record(rec: dict, cols: dict) -> dict:
    """A reference tick in the shape of a program's tick record, so the
    control can stand where the program stands."""
    out = {'pools': _Rows(cols, rec['out']), 'fleet': rec['fleet']}
    if 'control' in rec:
        c = rec['control']
        out['control'] = {
            'decisions': dict(c['decisions'], epoch=np.asarray(c['epoch'])),
            'fleet': c['fleet']}
    if 'health' in rec:
        out['health'] = rec['health']
    return out
