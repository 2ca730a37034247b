"""The routed fleet's reference: a ``synthetic_fleet`` spread over the
shards of a consistent-hash ring, each shard's pools carried by the
step math of ``steps`` on their own, and the shard records reduced to
one fleet record per pass.

This decides ``correct`` for a routed cell. It imports nothing of the
program: the ring, the placement of pools, the reductions and the
comparison of a pass are written out here once, from what the program
documents, and are not edited when the program changes.

- The ring (``Ring``): each shard owns ``replicas`` points, the keyed
  BLAKE2b hash of ``b'shard:<sid>:<replica>'``; a key ``k`` hashes
  ``b'key:' + k`` and lands on the first point clockwise (ties between
  shards broken by the lower shard id). Pool ``i`` is named
  ``pool-%05d``, and its name is its key.
- Rows: shard ``s`` holds its pools in ascending pool index, rows 0 to
  ``n_s - 1`` of ``capacity`` rows; the rows past them are unoccupied
  (no load, no CoDel, no spares, inactive). The reference compares
  pools, not rows: the program's rows are read through its own pool
  -> row map.
- Clock: every shard's sampler starts on the first pass, so its epoch
  is the clock of that pass.
- The health tables: the host offers every finished claim to every
  backend sink, whichever shard's loop completes it, so each shard's
  table sees the claims of all shards, and every shard's health record
  is the same one record (PERF.md, the sinks finding).
- The reductions, from the program's docstrings, in float64: for the
  fleet, pool counts sum, means and fractions weight by each shard's
  pool count, ``max_sojourn`` and ``loop_lag_p99_us`` take the worst
  shard (no loop-lag sampler runs, so the latter reads 0); for control,
  pool counts and decision counts sum, pressure and mean load weight by
  pool count, ``max_sojourn`` takes the worst; for health, gray sets
  union, counts sum, the error rate weights by ops, burn rates and the
  claim p99 take the worst shard, alerts take any.
"""

from __future__ import annotations

import bisect
import hashlib
import math

import numpy as np

from .. import compare
from . import steps
from .fleet_model import CONTROL_EPOCH_TTL
from .follow import BOOL_INPUTS, FLOAT_INPUTS, Follower
from .steps import (CODEL_TARGET_MAX, CODEL_TARGET_MIN, EPOCH_LIMIT,
                    EPOCH_MARGIN)

#: The passes repeat in this cycle; pass ``k`` (from 1) is
#: ``CYCLE[(k - 1) % len(CYCLE)]``.
CYCLE = ('sample', 'sample', 'sample', 'control', 'health')

#: name -> 'count' (summed over the passes compared) or 'err' (their
#: max): the fleet cell's numbers, each over every shard, and the
#: routed ones.
KINDS = dict(compare.KINDS, shard_mismatch='count', reduce_err='err',
             reduce_mismatch='count')

#: A row past a shard's pools.
_EMPTY = {'samples': 0.0, 'sojourns': 0.0, 'target_delay': math.inf,
          'spares': 0.0, 'maximum': 0.0, 'retry_delay': 0.0,
          'retry_max_delay': 0.0, 'retry_attempt': 0.0, 'n_retrying': 0.0,
          'active': False, 'reset': False}

#: Integer and flag fields of the reduced health record.
_HEALTH_EXACT = ('n_backends', 'n_gray', 'ops', 'errors', 'shed',
                 'alert_page', 'alert_ticket')


def pool_name(i: int) -> str:
    return 'pool-%05d' % i


def pool_uuid(i: int) -> str:
    return 'synthetic-%d' % i


# -- the ring -----------------------------------------------------------------

def _hash64(data: bytes, seed: int) -> int:
    h = hashlib.blake2b(data, digest_size=8,
                        key=seed.to_bytes(8, 'little', signed=False))
    return int.from_bytes(h.digest(), 'big')


class Ring:
    """Consistent-hash placement of keys on shards ``0 .. shards-1``."""

    def __init__(self, shards: int, replicas: int, seed: int):
        seed &= 0xffffffffffffffff
        self.seed = seed
        points = sorted((_hash64(b'shard:%d:%d' % (sid, rep), seed), sid)
                        for sid in range(shards) for rep in range(replicas))
        self.points = [p for p, _ in points]
        self.owners = [o for _, o in points]

    def assign(self, key: str) -> int:
        kh = _hash64(('key:%s' % key).encode('utf-8'), self.seed)
        i = bisect.bisect_right(self.points, kh)
        return self.owners[i % len(self.points)]


def split(cfg: dict) -> np.ndarray:
    """The shard of each pool of ``cfg``, pool index order."""
    ring = Ring(int(cfg['shards']), int(cfg['replicas']),
                int(cfg['ring_seed']))
    return np.array([ring.assign(pool_name(i))
                     for i in range(int(cfg['pools']))], np.int64)


# -- the fleet's inputs -------------------------------------------------------

class RoutedModel:
    """The synthetic fleet's input columns for every shard, worked out
    from the benchmark's draws alone, and the pools' side of the
    actuation (``fleet_model.FleetModel``'s rules, per shard)."""

    def __init__(self, cfg: dict, owner: np.ndarray):
        n = int(cfg['pools'])
        idx = np.arange(n)
        self.members = [np.nonzero(owner == s)[0]
                        for s in range(int(cfg['shards']))]
        self.capacity = int(cfg['capacity'])
        if max(len(m) for m in self.members) > self.capacity:
            raise ValueError('a shard holds more pools than its capacity')
        self.clock = float(cfg['clock_start_ms'])
        self.epoch = None
        self.tick_ms = float(cfg['tick_ms'])
        self.taps = int(cfg['taps'])
        self.actuation = bool(cfg['control_actuation'])
        self.load = (idx % int(cfg['initial_load_mod'])).astype(np.float32)
        self.target_delay = np.where(idx % int(cfg['codel_every']) == 0,
                                     float(cfg['codel_target_ms']),
                                     np.inf).astype(np.float32)
        self.head = np.where(idx % int(cfg['waiter_every']) == 0,
                             self.clock - (idx % int(cfg['waiter_age_mod_ms'])
                                           ).astype(np.float64), 0.0)
        self.spares = np.full(n, float(cfg['spares']), np.float32)
        self.maximum = np.full(n, float(cfg['maximum']), np.float32)
        self.has_codel = np.isfinite(self.target_delay)
        self.ctrl_epoch = np.zeros(n, np.int64)
        self.ctrl_at = np.full(n, -np.inf)
        self.first = True

    def _shard_columns(self, s: int, glob: dict) -> dict:
        m = self.members[s]
        cols = {}
        for k in FLOAT_INPUTS + BOOL_INPUTS:
            dtype = bool if k in BOOL_INPUTS else np.float32
            col = np.full(self.capacity, _EMPTY[k], dtype)
            col[:len(m)] = glob[k][m]
            cols[k] = col
        return cols

    def tick(self, rows, loads) -> tuple:
        """Advance one pass in which pools ``rows`` took ``loads``.
        Returns (each shard's input columns, epoch-relative now, rebase
        shift or None)."""
        self.clock += self.tick_ms
        if self.epoch is None:
            self.epoch = self.clock
        self.load[np.asarray(rows, np.int64)] = loads
        now = self.clock - self.epoch
        shift = None
        if now > EPOCH_LIMIT:
            shift = now - EPOCH_MARGIN
            self.epoch += shift
            now -= shift
        n = len(self.load)
        zeros = np.zeros(n, np.float32)
        glob = {'samples': self.load,
                'sojourns': np.where(self.head > 0.0, self.clock - self.head,
                                     0.0).astype(np.float32),
                'target_delay': self.target_delay, 'spares': self.spares,
                'maximum': self.maximum, 'retry_delay': zeros,
                'retry_max_delay': zeros, 'retry_attempt': zeros,
                'n_retrying': zeros, 'active': np.ones(n, bool),
                'reset': np.full(n, self.first)}
        self.first = False
        cols = [self._shard_columns(s, glob)
                for s in range(len(self.members))]
        return cols, now, shift

    def actuate(self, tick: int, s: int, control: dict) -> tuple:
        """Offer shard ``s``'s decisions of pass ``tick`` (a reference
        record's ``control``) to its pools and apply what each accepts;
        it shows in the next pass's columns. Returns (applied,
        rejected)."""
        m = self.members[s]
        if not self.actuation or tick < self.taps or not len(m):
            return 0, 0
        dec, epoch = control['decisions'], int(control['epoch'])
        ct = np.asarray(dec['codel_target'], np.float32)[:len(m)]
        sp = np.asarray(dec['plan_spares']).astype(np.float32)[:len(m)]
        given = ct > 0.0
        fresh = (epoch > self.ctrl_epoch[m]) | (
            self.clock - self.ctrl_at[m] > CONTROL_EPOCH_TTL)
        bad = given & ~(self.has_codel[m] & (ct >= CODEL_TARGET_MIN)
                        & (ct <= CODEL_TARGET_MAX))
        bad |= (sp < 0.0) | (sp > self.maximum[m])
        ok = fresh & ~bad
        took = m[ok]
        self.ctrl_epoch[took] = epoch
        self.ctrl_at[took] = self.clock
        self.target_delay[took[given[ok]]] = ct[ok & given]
        self.spares[took] = sp[ok]
        applied = int(ok.sum())
        return applied, len(m) - applied


# -- the shards' steps ----------------------------------------------------

class _Health(Follower):
    """The health step alone, over every claim the benchmark offered."""

    def __init__(self, device, lowp: bool, initial_keys):
        super().__init__(1, 1, device, lowp=lowp, initial_keys=initial_keys)

    def tick_health(self) -> dict:
        self.health, ver, fleet, epoch = steps.health_step(
            self.health, self.backends.drain(self.device), self.lowp)
        return self._publish(ver, fleet, epoch)


class RoutedFollower:
    """One reference fleet per shard, plus the health table every shard
    shares, on ``device``."""

    def __init__(self, cfg: dict, device, lowp: bool = False,
                 initial_keys=('',)):
        self.shards = [Follower(int(cfg['capacity']), int(cfg['taps']),
                                device, lowp=lowp)
                       for _ in range(int(cfg['shards']))]
        self.table = _Health(device, lowp, initial_keys)
        self.control = bool(cfg['control'])
        self.health = bool(cfg['health'])

    def rebase(self, shift: float) -> None:
        for f in self.shards:
            f.rebase(shift)

    def observe(self, keys: list, groups: list) -> None:
        """Finished claims in the order the program's sinks took them:
        ``groups`` holds, shard by shard, (backend index, ms, ok)."""
        for b, ms, ok in groups:
            if len(b):
                self.table.backends.observe_many(keys, b, ms, ok)

    def tick(self, cols: list, now_ms: float) -> list:
        """Every shard's record of one pass."""
        recs = [f.tick(c, now_ms, self.control, False)
                for f, c in zip(self.shards, cols)]
        if self.health:
            health = self.table.tick_health()
            for rec in recs:
                rec['health'] = health
        return recs


# -- the reductions -----------------------------------------------------------

def _weighted(rows: list, name: str, weight: str) -> float:
    tot = sum(float(r[weight]) for r in rows)
    safe = tot if tot > 0.0 else 1.0
    return sum(float(r[name]) * float(r[weight]) for r in rows) / safe


def reduce_fleet(fleets: list) -> dict:
    out = {'n_pools': sum(float(f['n_pools']) for f in fleets)}
    for name in ('mean_load', 'mean_filtered', 'overload_frac',
                 'retry_frac', 'mean_retry_backoff'):
        out[name] = _weighted(fleets, name, 'n_pools')
    out['max_sojourn'] = max(float(f['max_sojourn']) for f in fleets)
    out['loop_lag_p99_us'] = max(float(f.get('loop_lag_p99_us', 0.0))
                                 for f in fleets)
    return out


def reduce_control(controls: list) -> dict:
    fleets = [c['fleet'] for c in controls]
    out = {'n_pools': sum(float(f['n_pools']) for f in fleets),
           'pressure': _weighted(fleets, 'pressure', 'n_pools'),
           'mean_load': _weighted(fleets, 'mean_load', 'n_pools'),
           'max_sojourn': max(float(f['max_sojourn']) for f in fleets)}
    for k in ('applied', 'rejected', 'skipped'):
        out[k] = sum(int(c.get(k, 0)) for c in controls)
    return out


def reduce_health(records: list) -> dict:
    fleets = [r['fleet'] for r in records]
    gray = sorted(set().union(*(r['gray'] for r in records)))
    out = {k: sum(int(f[k]) for f in fleets)
           for k in ('n_backends', 'ops', 'errors', 'shed')}
    out.update(gray=gray, n_gray=len(gray),
               err_rate=_weighted(fleets, 'err_rate', 'ops'),
               claim_p99_ms=max(float(f['claim_p99_ms']) for f in fleets),
               burn_fast=max(float(f['burn_fast']) for f in fleets),
               burn_slow=max(float(f['burn_slow']) for f in fleets),
               alert_page=any(bool(f['alert_page']) for f in fleets),
               alert_ticket=any(bool(f['alert_ticket']) for f in fleets))
    return out


def expected(kind: str, recs: list, counts: list) -> dict:
    """The reference's pass: each shard's record (its control record
    with the decisions its pools took, ``counts``) and the reduced
    record of a pass of ``kind``."""
    for rec, (applied, rejected) in zip(recs, counts):
        if 'control' in rec:
            rec['control'].update(applied=applied, rejected=rejected,
                                  skipped=0)
    if kind == 'sample':
        reduced = reduce_fleet([r['fleet'] for r in recs])
    elif kind == 'control':
        reduced = reduce_control([r['control'] for r in recs])
    else:
        reduced = reduce_health([r['health'] for r in recs])
    return {'kind': kind, 'shards': recs, 'reduced': reduced}


class _Rows:
    """Columns under the names a sampler's row view gives them."""

    def __init__(self, rows: dict, cols: dict, out: dict):
        self.tp_rows = rows
        self.tp_cols = cols
        self.tp_out = out


def stand_in(want: dict, cols: list, members: list) -> dict:
    """A reference pass in the shape of the program's, so that the
    control can stand where the program stands."""
    shards = []
    for rec, c, m in zip(want['shards'], cols, members):
        got = {'pools': _Rows({pool_uuid(int(i)): r for r, i in enumerate(m)},
                              c, rec['out']),
               'fleet': rec['fleet']}
        if 'control' in rec:
            ctl = rec['control']
            got['control'] = dict(
                ctl, decisions=dict(ctl['decisions'],
                                    epoch=np.asarray(ctl['epoch'])))
        if 'health' in rec:
            got['health'] = rec['health']
        shards.append(got)
    return {'kind': want['kind'], 'shards': shards,
            'reduced': want['reduced']}


# -- the comparison of a pass -----------------------------------------------

def _pool_rows(record: dict, m: np.ndarray, s: int, owner) -> tuple:
    """(the program's row of each of shard ``s``'s pools, or None if
    any is missing; the pools sampled on the wrong shard or not on
    their own)."""
    rows = record['pools'].tp_rows
    wrong = sum(1 for u in rows
                if not u.startswith('synthetic-')
                or owner[int(u[len('synthetic-'):])] != s)
    idx = [rows.get(pool_uuid(int(i))) for i in m]
    missing = sum(r is None for r in idx)
    if missing:
        return None, wrong + missing
    return np.asarray(idx, np.int64), wrong


def _taken(cols: dict, idx: np.ndarray) -> dict:
    return {k: np.asarray(v)[idx] for k, v in cols.items()}


def _head(cols: dict, n: int) -> dict:
    return {k: np.asarray(v)[:n] for k, v in cols.items()}


def compare_pass(got: dict, want: dict, cols: list, members: list,
                 owner) -> dict:
    """Readings of one pass: ``got`` is the program's (each shard's
    tick record and the pass's reduced record), ``want`` the
    reference's, ``cols`` each shard's input columns as the reference
    worked them out."""
    readings = []
    shard_mismatch = decision = 0
    for s, m in enumerate(members):
        g = got['shards'][s]
        w = want['shards'][s]
        idx, wrong = _pool_rows(g, m, s, owner)
        shard_mismatch += wrong
        if idx is None:
            continue
        n = len(m)
        gp = g['pools']
        gv = {'pools': _Rows(None, _taken(gp.tp_cols, idx),
                             _taken(gp.tp_out, idx)),
              'fleet': g['fleet']}
        wv = {'out': _head(w['out'], n), 'fleet': w['fleet']}
        if 'control' in w:
            gc, wc = g['control'], w['control']
            dec = _taken({k: v for k, v in gc['decisions'].items()
                          if k != 'epoch'}, idx)
            gv['control'] = {'fleet': gc['fleet'],
                             'decisions': dict(
                                 dec, epoch=gc['decisions']['epoch'])}
            wv['control'] = dict(wc, decisions=_head(wc['decisions'], n))
            decision += sum(int(gc.get(k, 0)) != int(wc[k])
                            for k in ('applied', 'rejected', 'skipped'))
        if 'health' in w:
            gv['health'], wv['health'] = g['health'], w['health']
        readings.append(compare.compare_tick(gv, wv, _head(cols[s], n)))
    out = merge(readings)
    out['decision_mismatch'] = out.get('decision_mismatch', 0) + decision
    out['shard_mismatch'] = shard_mismatch
    out.update(_compare_reduced(got['reduced'], want))
    return out


def _compare_reduced(got: dict, want: dict) -> dict:
    w = want['reduced']
    err, mism = 0.0, 0
    if set(got) != set(w):
        return {'reduce_err': math.inf, 'reduce_mismatch': 1}
    edge = want['kind'] == 'health' and any(
        compare.score_boundary(b['ewma_ms'])
        for r in want['shards'] for b in r['health']['backends'].values())
    for k, v in w.items():
        if k in ('applied', 'rejected', 'skipped'):
            mism += int(int(got[k]) != v)
        elif k == 'gray':
            mism += int(not edge and list(got[k]) != v)
        elif k in _HEALTH_EXACT:
            mism += int(not edge and got[k] != v)
        else:
            err = max(err, compare.rel_err(got[k], v))
    return {'reduce_err': err, 'reduce_mismatch': mism}


def merge(readings: list) -> dict:
    """Readings of many passes (or shards) as one: counts add up,
    errors take the widest."""
    out = {}
    for r in readings:
        for k, v in r.items():
            if KINDS[k] == 'count':
                out[k] = out.get(k, 0) + v
            else:
                out[k] = max(out.get(k, 0.0), v)
    return out
