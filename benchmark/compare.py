"""The comparison that decides ``correct``: a tick of the program's
fleet sampler held against the same tick of the reference.

Each number compared is either a count of disagreements (its limit is
0) or the widest relative error ``|got - want| / max(1, |want|)`` of a
group of floats (its limit is set from readings; see PERF.md). Rows
within rounding of a decision boundary, where two correct float32
implementations may round apart, are left out of the exact counts by
the rules below, and only there:

- ``target``, ``clamped``, ``plan_target`` and ``delta``: rows whose
  reference ``filtered`` lies within 1e-4 of an integer, or whose raw
  target lies within 1e-4 of 1.05 times its ceiling;
- ``plan_spares``: rows whose reference ``filtered + 1`` lies within
  1e-4 of their spares;
- a backend's ``score`` (and its gray verdict): backends whose
  ``16 * log2(1 + ewma)`` lies within 1e-4 of a half-integer.
"""

from __future__ import annotations

import math

import numpy as np

from .reference.follow import BOOL_INPUTS, FLOAT_INPUTS

#: name -> 'count' (summed over the ticks compared) or 'err' (their max).
KINDS = {
    'input_mismatch': 'count',
    'live_err': 'err',
    'live_mismatch': 'count',
    'aggregate_err': 'err',
    'decision_mismatch': 'count',
    'verdict_mismatch': 'count',
    'health_err': 'err',
    'missing_ticks': 'count',
}

EPS = 1e-4
#: Health fleet fields that are integer work, compared exactly.
HEALTH_EXACT = ('n_backends', 'median_score', 'mad_score', 'ops', 'errors',
                'shed', 'n_gray', 'alert_page', 'alert_ticket')


def rel_err(got, want) -> float:
    """Widest ``|got - want| / max(1, |want|)``; equal infinities read
    0, and a NaN on one side only reads inf."""
    g = np.asarray(got, np.float64).ravel()
    w = np.asarray(want, np.float64).ravel()
    if g.shape != w.shape:
        return math.inf
    if g.size == 0:
        return 0.0
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    with np.errstate(invalid='ignore'):
        err = np.abs(g - w) / np.maximum(1.0, np.abs(w))
    err = np.where(same, 0.0, err)
    err = np.where(np.isnan(err), math.inf, err)
    return float(err.max())


def target_boundary(filtered, samples, spares):
    frac = filtered - np.floor(filtered)
    near_int = (frac < EPS) | (frac > 1.0 - EPS)
    near_clamp = np.abs(samples + spares - np.ceil(filtered) * 1.05) < EPS
    return near_int | near_clamp


def score_boundary(ewma) -> bool:
    x = 16.0 * math.log2(1.0 + ewma) if ewma > -1.0 else math.inf
    return math.isfinite(x) and abs(x - math.floor(x) - 0.5) < EPS


def record_columns(record) -> tuple:
    """(input columns, per-row outputs) of a sampler tick record, as
    numpy, read through the record's row view."""
    pools = record['pools']
    cols = getattr(pools, 'tp_cols', None)
    out = getattr(pools, 'tp_out', None)
    if cols is not None and out is not None:
        return cols, out
    # A plain mapping of per-pool entries: rebuild the columns by row.
    entries = sorted(pools.values(), key=lambda e: e['row'])
    n = entries[-1]['row'] + 1 if entries else 0
    cols = {k: np.zeros(n, np.float32) for k in FLOAT_INPUTS}
    out = {k: np.zeros(n, np.float32) for k in ('filtered', 'target',
                                                  'retry_backoff')}
    out.update({k: np.zeros(n, bool) for k in ('clamped', 'drop')})
    for e in entries:
        r = e['row']
        for k, v in e['inputs'].items():
            key = 'samples' if k == 'sample' else (
                'sojourns' if k == 'sojourn' else k)
            cols[key][r] = math.inf if v is None else v
        for k in out:
            out[k][r] = e[k]
    return cols, out


def compare_tick(got: dict, want: dict, inputs: dict) -> dict:
    """Readings of one tick: ``got`` is the program's tick record,
    ``want`` the reference's, ``inputs`` the input columns the
    reference worked out from the benchmark's own draws."""
    r = {}
    gcols, gout = record_columns(got)
    wout = want['out']
    r['input_mismatch'] = sum(
        int(np.sum(~_equal(gcols[k], inputs[k])))
        for k in FLOAT_INPUTS + BOOL_INPUTS)
    cols = inputs
    r['live_err'] = max(rel_err(gout['filtered'], wout['filtered']),
                        rel_err(gout['retry_backoff'], wout['retry_backoff']))
    off = ~target_boundary(wout['filtered'].astype(np.float64),
                           np.asarray(cols['samples'], np.float64),
                           np.asarray(cols['spares'], np.float64))
    mism = int(np.sum(gout['drop'] != wout['drop']))
    for k in ('target', 'clamped'):
        mism += int(np.sum((gout[k] != wout[k]) & off))
    r['live_mismatch'] = mism
    agg = [rel_err(got['fleet'][k], v) for k, v in want['fleet'].items()]

    mism = 0
    if 'control' in want:
        gc, wc = got['control'], want['control']
        gd, wd = gc['decisions'], wc['decisions']
        mism += int(np.sum(gd['codel_target'] != wd['codel_target']))
        for k in ('plan_target', 'delta'):
            mism += int(np.sum((gd[k] != wd[k]) & off))
        off_spares = np.abs(wout['filtered'].astype(np.float64) + 1.0
                            - np.asarray(cols['spares'], np.float64)) >= EPS
        mism += int(np.sum((gd['plan_spares'] != wd['plan_spares'])
                           & off_spares))
        mism += int(int(gd['epoch']) != wc['epoch'])
        agg += [rel_err(gc['fleet'][k], v) for k, v in wc['fleet'].items()]
    r['decision_mismatch'] = mism

    mism, herr = 0, 0.0
    if 'health' in want:
        gh, wh = got['health'], want['health']
        mism += int(gh['epoch'] != wh['epoch'])
        gb, wb = gh['backends'], wh['backends']
        mism += len(set(gb) ^ set(wb))
        for key, w in wb.items():
            g = gb.get(key)
            if g is None:
                continue
            if not score_boundary(w['ewma_ms']):
                mism += int(g['gray'] != w['gray'])
                mism += int(g['score'] != w['score'])
            herr = max(herr, rel_err(g['ewma_ms'], w['ewma_ms']),
                       rel_err(g['z'], w['z']))
        edge = any(score_boundary(w['ewma_ms']) for w in wb.values())
        if not edge:
            mism += int(list(gh['gray']) != list(wh['gray']))
        for k, v in wh['fleet'].items():
            if k in HEALTH_EXACT:
                mism += int(not edge and gh['fleet'][k] != v)
            else:
                agg.append(rel_err(gh['fleet'][k], v))
    r['verdict_mismatch'] = mism
    r['health_err'] = herr
    r['aggregate_err'] = max(agg) if agg else 0.0
    return r


def _equal(got, want):
    g = np.asarray(got)
    w = np.asarray(want)
    if g.shape != w.shape:
        return np.zeros(max(g.size, w.size, 1), bool)
    if g.dtype.kind == 'f' or w.dtype.kind == 'f':
        g = g.astype(np.float64)
        w = w.astype(np.float64)
        return (g == w) | (np.isnan(g) & np.isnan(w))
    return g == w


def merge(readings: list) -> dict:
    """Readings of many ticks as one: counts add up, errors take the
    widest."""
    out = {}
    for r in readings:
        for k, v in r.items():
            if KINDS[k] == 'count':
                out[k] = out.get(k, 0) + v
            else:
                out[k] = max(out.get(k, 0.0), v)
    return out


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) for every number compared. A
    number the readings lack, or a limit the cell lacks, is not
    correct."""
    rows, ok = [], True
    for name in sorted(set(readings) | set(limits)):
        value = readings.get(name)
        limit = limits.get(name)
        good = (value is not None and limit is not None
                and not (isinstance(value, float) and math.isnan(value))
                and value <= limit)
        ok &= good
        rows.append((name, value, limit))
    return ok, rows
