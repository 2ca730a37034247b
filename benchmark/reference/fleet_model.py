"""The synthetic fleet's input columns, worked out from the benchmark's
own draws and never read from the program: what a sampler gathering
every pool of a ``synthetic_fleet`` configuration must see each tick.

Pool ``i`` holds row ``i``: load ``i % initial_load_mod`` until a draw
changes it, a CoDel target of ``codel_target_ms`` on every
``codel_every``-th pool, a claim waiting since ``clock_start_ms - (i %
waiter_age_mod_ms)`` on every ``waiter_every``-th pool, the configured
spares and maximum, and no slot in backoff. The clock starts at
``clock_start_ms`` and moves ``tick_ms`` before every tick; the
sampler's epoch is the clock at its start. With ``control_actuation``
every pool takes each decision the control step offers it once its row
has seen ``taps`` ticks, under the pool layer's checks: a fresh epoch,
a CoDel target only for a pool with a CoDel queue and within its
range, spares within ``[0, maximum]``.
"""

from __future__ import annotations

import numpy as np

from .steps import (CODEL_TARGET_MAX, CODEL_TARGET_MIN, EPOCH_LIMIT,
                    EPOCH_MARGIN)

#: A pool takes a decision whose epoch is not fresh once its last one
#: is older than this (ms).
CONTROL_EPOCH_TTL = 5000.0


class FleetModel:
    def __init__(self, cfg: dict):
        n = int(cfg['pools'])
        idx = np.arange(n)
        self.clock = float(cfg['clock_start_ms'])
        self.epoch = self.clock
        self.tick_ms = float(cfg['tick_ms'])
        self.load = (idx % int(cfg['initial_load_mod'])).astype(np.float32)
        self.target_delay = np.where(idx % int(cfg['codel_every']) == 0,
                                     float(cfg['codel_target_ms']),
                                     np.inf).astype(np.float32)
        self.head = np.where(idx % int(cfg['waiter_every']) == 0,
                             self.clock - (idx % int(cfg['waiter_age_mod_ms'])
                                           ).astype(np.float64), 0.0)
        self.spares = np.full(n, float(cfg['spares']), np.float32)
        self.maximum = np.full(n, float(cfg['maximum']), np.float32)
        self.zeros = np.zeros(n, np.float32)
        self.active = np.ones(n, bool)
        self.first = True
        self.taps = int(cfg['taps'])
        self.actuation = bool(cfg['control_actuation'])
        self.has_codel = np.isfinite(self.target_delay)
        self.ctrl_epoch = np.zeros(n, np.int64)
        self.ctrl_at = np.full(n, -np.inf)

    def tick(self, rows, loads) -> tuple:
        """Advance one tick in which pools ``rows`` took ``loads``.
        Returns (input columns, epoch-relative now, rebase shift or
        None)."""
        self.clock += self.tick_ms
        self.load[np.asarray(rows, np.int64)] = loads
        now = self.clock - self.epoch
        shift = None
        if now > EPOCH_LIMIT:
            shift = now - EPOCH_MARGIN
            self.epoch += shift
            now -= shift
        sojourns = np.where(self.head > 0.0, self.clock - self.head,
                            0.0).astype(np.float32)
        cols = {'samples': self.load.copy(), 'sojourns': sojourns,
                'target_delay': self.target_delay, 'spares': self.spares,
                'maximum': self.maximum, 'retry_delay': self.zeros,
                'retry_max_delay': self.zeros, 'retry_attempt': self.zeros,
                'n_retrying': self.zeros, 'active': self.active,
                'reset': np.full(len(self.load), self.first)}
        self.first = False
        return cols, now, shift

    def actuate(self, tick: int, control: dict) -> None:
        """Offer tick ``tick``'s decisions (a reference tick's
        ``control``) to the pools, and apply what each accepts; it
        shows in the next tick's columns."""
        if not self.actuation or tick < self.taps:
            return
        dec, epoch = control['decisions'], int(control['epoch'])
        ct = np.asarray(dec['codel_target'], np.float32)
        sp = np.asarray(dec['plan_spares']).astype(np.float32)
        given = ct > 0.0
        fresh = (epoch > self.ctrl_epoch) | (
            self.clock - self.ctrl_at > CONTROL_EPOCH_TTL)
        bad = given & ~(self.has_codel & (ct >= CODEL_TARGET_MIN)
                        & (ct <= CODEL_TARGET_MAX))
        bad |= (sp < 0.0) | (sp > self.maximum)
        ok = fresh & ~bad
        self.ctrl_epoch[ok] = epoch
        self.ctrl_at[ok] = self.clock
        self.target_delay = np.where(ok & given, ct, self.target_delay
                                     ).astype(np.float32)
        self.spares = np.where(ok, sp, self.spares).astype(np.float32)
