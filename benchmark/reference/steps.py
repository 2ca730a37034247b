"""The fleet runtime's step math in plain PyTorch, frozen for the
benchmark: the live step (128-tap FIR, rebalance target, CoDel,
backoff, fleet aggregates), the control step and the health step.

This is the yardstick that decides ``correct``. It imports nothing of
the program: the laws are written out here once and are not edited
when the program changes. Every function takes and returns tensors on
whatever device its inputs live on (the CPU in the tests, the card
after a run's window has closed).

Precision. The laws are float32, as the program states them, with two
differences that only make the reference more exact: the FIR and the
fleet sums accumulate in float64 and round once to float32.

``lowp=True`` is the benchmark's control: the same laws one precision
step below float32. The FIR, a dot product, runs on TF32 operands (10
mantissa bits, what a tensor-core FIR would use); the per-backend EWMA
and the fleet aggregates are rounded to bfloat16. A comparison that
cannot tell this control from the program is too loose.
"""

from __future__ import annotations

import math
import typing

import torch

F32 = torch.float32
F64 = torch.float64
I32 = torch.int32

TAPS = 128
TAP_TC = -0.2                 # lib/pool.js:44-100, genTaps(128, -0.2)
CODEL_INTERVAL = 100.0        # ms, lib/codel.js
CODEL_TARGET_MIN = 1.0
CODEL_TARGET_MAX = 60_000.0
EPOCH_LIMIT = float(2 ** 20)  # the sampler rebases its clock past this
EPOCH_MARGIN = 1000.0

# Control law.
TIGHTEN_MULT = 0.875
RELAX_STEP_MS = 1.0
PRESSURE_HOT = 0.25
PRESSURE_IDLE = 0.05

# Health law.
LAT_BINS = 64
BUCKET_SCALE = 4.0
SCORE_BINS = 256
SCORE_SCALE = 16.0
EWMA_ALPHA = 0.3
SKETCH_DECAY = 0.9
Z_THRESHOLD = 3.5
GRAY_FLOOR_Q = 16
MIN_BASELINE = 4
ENTER_STREAK = 3
EXIT_STREAK = 5
FAST_ALPHA = 0.5
SLOW_ALPHA = 0.05
FAST_BURN_ALERT = 14.4
SLOW_BURN_ALERT = 6.0
SUCCESS_TARGET = 0.999
CLAIM_P99_MS = 250.0


# -- precision helpers ------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: 10 mantissa bits, round to
    nearest even."""
    i = x.contiguous().view(I32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & ~0x1FFF).view(F32)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(F32)


def to_int32_saturating(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 as the program states its casts: NaN to 0, out of
    range to the nearest bound, else toward zero."""
    wide = torch.nan_to_num(x.to(F64), nan=0.0)
    return wide.clamp(-2147483648.0, 2147483647.0).to(I32)


def gen_taps(count: int = TAPS, device=None) -> torch.Tensor:
    """Normalised EMA taps; taps[0] weights the newest sample."""
    taps = torch.exp(TAP_TC * torch.arange(count, dtype=F32, device=device))
    return taps / torch.sum(taps)


# -- the live step ----------------------------------------------------------

class LiveState(typing.NamedTuple):
    windows: torch.Tensor      # [P, K] f32 ring, oldest -> newest
    first_above: torch.Tensor  # [P] f32
    drop_next: torch.Tensor    # [P] f32
    count: torch.Tensor        # [P] f32
    dropping: torch.Tensor     # [P] bool


def live_init(n: int, taps: int = TAPS, device=None) -> LiveState:
    z = torch.zeros((n,), dtype=F32, device=device)
    return LiveState(torch.zeros((n, taps), dtype=F32, device=device),
                     z, z.clone(), z.clone(),
                     torch.zeros((n,), dtype=torch.bool, device=device))


def fir(windows: torch.Tensor, taps: torch.Tensor,
        lowp: bool = False) -> torch.Tensor:
    """out[p] = sum_c windows[p, c] * taps[K-1-c]."""
    rev = taps.flip(0)
    if lowp:
        return torch.sum(tf32(windows) * tf32(rev), dim=1)
    return (windows.to(F64) @ rev.to(F64)).to(F32)


def codel(target, st: LiveState, now, sojourn):
    """One CoDel control-law step per row (lib/codel.js); float32
    timestamps, as the program keeps them."""
    below = sojourn < target
    first_unset = st.first_above == 0.0
    new_first = torch.where(
        below, 0.0,
        torch.where(first_unset, now + CODEL_INTERVAL, st.first_above))
    ok_to_drop = (~below) & (~first_unset) & (now >= st.first_above)
    leave = st.dropping & ~ok_to_drop
    drop_in_run = st.dropping & ok_to_drop & (now >= st.drop_next)
    count_a = torch.where(drop_in_run, st.count + 1, st.count)
    recent = (now - st.drop_next) < CODEL_INTERVAL
    long_above = (now - st.first_above) >= CODEL_INTERVAL
    enter = (~st.dropping) & ok_to_drop & (recent | long_above)
    count_b = torch.where(
        enter, torch.where(recent & (count_a > 2), count_a - 2, 1.0),
        count_a)
    drop_next = torch.where(
        enter,
        now + CODEL_INTERVAL / torch.sqrt(torch.clamp_min(count_b, 1.0)),
        st.drop_next)
    dropping = (st.dropping & ~leave) | enter
    return new_first, drop_next, count_b, dropping, drop_in_run | enter


def rebase(st: LiveState, shift: float) -> LiveState:
    """Shift the CoDel timestamps back by ``shift`` ms, as the sampler
    does past EPOCH_LIMIT: unset (0) stays 0, older ones clamp to 1."""
    shift = torch.tensor(shift, dtype=F32, device=st.windows.device)
    fa, dn = st.first_above, st.drop_next
    return st._replace(
        first_above=torch.where(fa > 0.0, torch.clamp_min(fa - shift, 1.0),
                                0.0),
        drop_next=torch.where(dn > 0.0, torch.clamp_min(dn - shift, 1.0),
                              dn))


def _mean(total, n, lowp):
    out = (total / n).to(F32)
    return bf16(out) if lowp else out


def live_step(st: LiveState, inp: dict, now: torch.Tensor,
              lowp: bool = False):
    """(new state, per-row outputs, fleet aggregates) for one tick.
    ``inp`` holds [P] tensors: samples, sojourns, target_delay, spares,
    maximum, retry_delay, retry_max_delay, retry_attempt, n_retrying
    (float32) and active, reset (bool)."""
    rst = inp['reset']
    first = torch.where(rst, 0.0, st.first_above)
    dnext = torch.where(rst, 0.0, st.drop_next)
    count = torch.where(rst, 0.0, st.count)
    dropping = st.dropping & ~rst
    windows = torch.empty_like(st.windows)
    windows[:, :-1] = torch.where(rst[:, None], 0.0, st.windows[:, 1:])
    windows[:, -1] = inp['samples']
    filtered = fir(windows, gen_taps(windows.shape[1], windows.device), lowp)

    raw = inp['samples'] + inp['spares']
    lp_min = torch.ceil(filtered)
    clamped = raw < lp_min * 1.05
    target = torch.minimum(torch.where(clamped, lp_min, raw), inp['maximum'])

    first, dnext, count, dropping, drop = codel(
        inp['target_delay'], st._replace(first_above=first, drop_next=dnext,
                                         count=count, dropping=dropping),
        now, inp['sojourns'])

    retrying = inp['n_retrying'] > 0
    backoff = torch.minimum(
        inp['retry_delay'] * torch.exp2(inp['retry_attempt']),
        inp['retry_max_delay'])
    backoff = torch.where(retrying, backoff, 0.0)

    act = inp['active']
    actd = act.to(F64)
    retd = retrying.to(F64) * actd
    n = torch.clamp_min(actd.sum(), 1.0)
    n_retry = torch.clamp_min(retd.sum(), 1.0)
    fleet = {
        'n_pools': actd.sum().to(F32),
        'mean_load': _mean((inp['samples'].to(F64) * actd).sum(), n, lowp),
        'mean_filtered': _mean((filtered.to(F64) * actd).sum(), n, lowp),
        'overload_frac': _mean((drop.to(F64) * actd).sum(), n, lowp),
        'max_sojourn': torch.max(torch.where(act, inp['sojourns'], 0.0)),
        'retry_frac': _mean(retd.sum(), n, lowp),
        'mean_retry_backoff': _mean((backoff.to(F64) * retd).sum(), n_retry,
                                    lowp),
    }
    out = {'filtered': filtered, 'target': target, 'clamped': clamped,
           'drop': drop, 'retry_backoff': backoff}
    return (LiveState(windows, first, dnext, count, dropping), out, fleet)


# -- the control step -------------------------------------------------------

class ControlState(typing.NamedTuple):
    targets: torch.Tensor   # [P] f32 adapted CoDel target (0 = none)
    epoch: int


def control_init(n: int, device=None) -> ControlState:
    return ControlState(torch.zeros((n,), dtype=F32, device=device), 0)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def control_step(st: ControlState, inp: dict, filtered: torch.Tensor,
                 lowp: bool = False):
    """(new state, decision columns, fleet row): the AIMD CoDel target,
    the spares and target plans and their delta."""
    td = inp['target_delay']
    base = torch.where(torch.isfinite(td) & (td >= CODEL_TARGET_MIN),
                       torch.clamp_max(td, CODEL_TARGET_MAX), 0.0)
    has_codel = base > 0.0
    cur = torch.where(inp['reset'] | (st.targets <= 0.0), base, st.targets)
    cur = torch.where(has_codel, cur, 0.0)
    act = inp['active']
    over = act & has_codel & (inp['sojourns'] > cur)

    n_i = int(act.sum())
    n_over = int(over.sum())
    n = max(n_i, 1)
    pressure = torch.tensor(n_over, dtype=F32) / torch.tensor(n, dtype=F32)
    pressure = pressure.to(filtered.device)
    quiet = pressure < PRESSURE_IDLE

    relax = act & has_codel & ~over & quiet
    t = torch.where(over, torch.floor(cur * TIGHTEN_MULT), cur)
    t = torch.where(relax, t + RELAX_STEP_MS, t)
    t = _clip(torch.round(t), t.new_tensor(CODEL_TARGET_MIN), base)
    t = torch.where(act & has_codel, t, 0.0)

    raw = inp['samples'] + inp['spares']
    lp_min = torch.ceil(filtered)
    plan = torch.where(raw < lp_min * 1.05, lp_min, raw)
    plan = torch.minimum(plan, inp['maximum'])
    plan_target = to_int32_saturating(torch.round(plan))
    hot = pressure >= PRESSURE_HOT
    boost = torch.where(hot & over, 1.0, 0.0)
    shed = torch.where(quiet & (filtered + 1.0 < inp['spares']), 1.0, 0.0)
    plan_spares = to_int32_saturating(_clip(
        torch.round(inp['spares'] + boost - shed), t.new_tensor(0.0),
        inp['maximum']))
    delta = plan_target - to_int32_saturating(torch.round(raw))

    load = torch.where(act, inp['samples'], 0.0).to(F64).sum()
    epoch = st.epoch + 1
    decisions = {'codel_target': t, 'plan_spares': plan_spares,
                 'plan_target': plan_target, 'delta': delta}
    fleet = {'n_pools': float(n_i), 'pressure': float(pressure),
             'mean_load': float(_mean(load, float(n), lowp)),
             'max_sojourn': float(torch.max(
                 torch.where(act, inp['sojourns'], 0.0)))}
    return ControlState(t, epoch), decisions, fleet, epoch


# -- the health step --------------------------------------------------------

def latency_bucket(ms: float) -> int:
    if not ms > 0.0:
        return 0
    return min(int(math.log2(1.0 + ms) * BUCKET_SCALE), LAT_BINS - 1)


class HealthState(typing.NamedTuple):
    ewma: torch.Tensor         # [B] f32
    hist: torch.Tensor         # [B, LAT_BINS] f32
    gray_streak: torch.Tensor  # [B] i32
    ok_streak: torch.Tensor    # [B] i32
    gray: torch.Tensor         # [B] bool
    burn: tuple                # (fast err, slow err, fast lat, slow lat)
    epoch: int


def health_init(b: int, device=None) -> HealthState:
    zi = torch.zeros((b,), dtype=I32, device=device)
    return HealthState(torch.zeros((b,), dtype=F32, device=device),
                       torch.zeros((b, LAT_BINS), dtype=F32, device=device),
                       zi, zi.clone(),
                       torch.zeros((b,), dtype=torch.bool, device=device),
                       (0.0, 0.0, 0.0, 0.0), 0)


def _hist_median(hist: torch.Tensor, n: int) -> int:
    c = torch.cumsum(hist, 0)
    rank = max((n + 1) // 2, 1)
    hit = torch.nonzero(c >= rank)
    return int(hit[0]) if len(hit) else 0


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=F32))


def health_step(st: HealthState, inp: dict, lowp: bool = False):
    """(new state, verdict columns, fleet row). ``inp`` holds [B]
    columns lat_sum (f32), lat_count, errors, shed (i32), lat_buckets
    and claim_buckets ([B, LAT_BINS] i32), and active, eligible, reset
    (bool)."""
    rst = inp['reset']
    act = inp['active']
    cnt = inp['lat_count']
    mean = inp['lat_sum'].to(F32) / torch.clamp_min(cnt.to(F32), 1.0)
    have = act & (cnt > 0)
    prev = torch.where(rst, 0.0, st.ewma)
    ewma = torch.where(
        have, torch.where(prev > 0.0, prev + EWMA_ALPHA * (mean - prev), mean),
        prev)
    if lowp:
        ewma = bf16(ewma)
    hist = torch.where(rst[:, None], 0.0, st.hist)
    hist = hist * SKETCH_DECAY + inp['lat_buckets'].to(F32)
    score = to_int32_saturating(torch.clamp(
        torch.round(SCORE_SCALE * torch.log2(1.0 + ewma)), 0, SCORE_BINS - 1))
    considered = inp['eligible'] & ~rst & (ewma > 0.0)

    n = int(considered.sum())
    score_hist = torch.bincount(score[considered].to(torch.int64),
                                minlength=SCORE_BINS)
    med = _hist_median(score_hist, n)
    dev = torch.clamp(torch.abs(score - med), 0, SCORE_BINS - 1)
    mad = _hist_median(torch.bincount(dev[considered].to(torch.int64),
                                      minlength=SCORE_BINS), n)

    z = (score - med).to(F32) / float(max(mad, 1))
    raw = considered & (n >= MIN_BASELINE) & (z > Z_THRESHOLD) & (
        score >= med + GRAY_FLOOR_Q)
    gray_streak = torch.where(
        raw, torch.where(rst, 0, st.gray_streak) + 1, 0).to(I32)
    ok_streak = torch.where(
        raw, 0, torch.where(rst, 0, st.ok_streak) + 1).to(I32)
    prev_gray = st.gray & ~rst
    gray = torch.where(gray_streak >= ENTER_STREAK, True,
                       torch.where(ok_streak >= EXIT_STREAK, False,
                                   prev_gray)) & considered

    ok = int(torch.where(act, cnt, 0).sum())
    errors = int(torch.where(act, inp['errors'], 0).sum())
    shed = int(torch.where(act, inp['shed'], 0).sum())
    claim_hist = (inp['claim_buckets'] * act[:, None]).sum(0)
    ops = ok + errors
    err_rate = _f32(_f32(errors) / _f32(max(ops, 1)))
    c = torch.cumsum(claim_hist, 0)
    tot = int(c[-1])
    rank99 = max(tot - tot // 100, 1)
    hit = torch.nonzero(c >= rank99)
    k99 = int(hit[0]) if len(hit) else 0
    p99_ms = _f32(2.0 ** ((k99 + 1.0) / BUCKET_SCALE) - 1.0)
    kt = latency_bucket(CLAIM_P99_MS)
    over_frac = _f32((tot - int(c[kt])) / max(tot, 1))
    err_budget = max(1.0 - SUCCESS_TARGET, 1e-9)
    burn_err = _f32(err_rate / err_budget) if ops > 0 else 0.0
    burn_lat = _f32(over_frac / 0.01) if tot > 0 else 0.0
    fe, se, fl, sl = st.burn
    fe = _f32(fe + FAST_ALPHA * (burn_err - fe))
    se = _f32(se + SLOW_ALPHA * (burn_err - se))
    fl = _f32(fl + FAST_ALPHA * (burn_lat - fl))
    sl = _f32(sl + SLOW_ALPHA * (burn_lat - sl))
    if lowp:
        fe, se, fl, sl, err_rate, over_frac = (
            float(bf16(torch.tensor(v, dtype=F32)))
            for v in (fe, se, fl, sl, err_rate, over_frac))
    epoch = st.epoch + 1
    fleet = {
        'n_backends': n, 'median_score': med, 'mad_score': mad,
        'claim_p99_ms': p99_ms, 'err_rate': err_rate,
        'over_frac': over_frac, 'ops': ops, 'errors': errors, 'shed': shed,
        'burn_fast': max(fe, fl), 'burn_slow': max(se, sl),
        'alert_page': fe > FAST_BURN_ALERT or fl > FAST_BURN_ALERT,
        'alert_ticket': se > SLOW_BURN_ALERT or sl > SLOW_BURN_ALERT,
        'n_gray': int(gray.sum()),
    }
    verdicts = {'gray': gray, 'z': z, 'score': score, 'ewma': ewma}
    new = HealthState(ewma, hist, gray_streak, ok_streak, gray,
                      (fe, se, fl, sl), epoch)
    return new, verdicts, fleet, epoch
