"""Fleet control plane: one step that DECIDES, the counterpart of
``cueball_tpu.parallel.control`` on one device.

The step consumes the telemetry columns already on the device (the
FleetInputs the sampler placed for the telemetry tick plus the
telemetry step's own ``filtered`` output, so the sampler ships nothing
more to the device for it) and emits *decision columns*:

- ``codel_target`` [P] f32: per-pool CoDel target adaptation (AIMD:
  multiplicative tighten while the pool's head sojourn sits above its
  plan, additive relax back toward the configured target when the
  fleet is quiet; 0.0 = no decision for that row);
- ``plan_spares`` [P] i32: spares resize plan;
- ``plan_target`` [P] i32: the rebalance target-size plan (the
  telemetry step's LP-clamped law, rounded);
- ``delta`` [P] i32: ``plan_target`` minus the pool's raw target;
- ``epoch`` 0-dim i32: the decision epoch.

Every cross-pool reduction that feeds a decision is an int32 sum or a
max, so the decisions do not depend on summation order and agree bit
for bit with the JAX package's. ``mean_load`` is a float sum and feeds
gauges only. Integer columns stay int32: ``torch.sum`` of int32 returns
int64 unless told otherwise, so every sum names its dtype. The float
plans cast to int32 by XLA's saturating rule (:func:`to_int32_xla`), so
a NaN, infinite or out-of-range row decides as in the JAX package.

Sharding over a :class:`~.mesh.Mesh` is derived from *regex partition
rules* (:func:`match_partition_rules`): one rule table names which
leaves replicate and which split over the pools axis, and every mesh
form and placement derives from it.

Actuation is on the host: :func:`apply_decisions` offers each pool its
row's decision through ``apply_control_decision``.
"""

from __future__ import annotations

import functools
import re
import typing

import numpy as np
import torch

from .._cast import to_int32_xla
from .._device import resolve_device
from ..codel import CODEL_TARGET_MAX, CODEL_TARGET_MIN
from .mesh import Mesh, Reducer, shard_tree, tree_map_with_path

__all__ = ['ControlInputs', 'ControlState', 'apply_decisions',
           'control_init', 'control_inputs', 'control_specs',
           'control_step', 'make_control_step',
           'make_shardmap_control_step', 'match_partition_rules',
           'partition_rules', 'reduce_control', 'shard_control_inputs',
           'shard_control_state']

#: AIMD law constants. Tighten is multiplicative (x0.875 per over-target
#: step), relax is additive (+1 ms per quiet step) and capped at the
#: pool's own configured target.
TIGHTEN_MULT = 0.875
RELAX_STEP_MS = 1.0
#: Fleet overload-fraction thresholds: above HOT the plan boosts one
#: spare on over-target pools; below IDLE targets relax and an unused
#: spare is shed.
PRESSURE_HOT = 0.25
PRESSURE_IDLE = 0.05

_I32 = torch.int32
_F32 = torch.float32

class ControlState(typing.NamedTuple):
    """Carried control-plane state."""
    targets: torch.Tensor  # [P] f32 adapted CoDel target (ms; 0 = none)
    epoch: torch.Tensor    # 0-dim i32 decision epoch
    now_ms: torch.Tensor   # 0-dim f32 clock of the last step


class ControlInputs(typing.NamedTuple):
    """One control tick's inputs (all [P] f32/bool except now_ms): a
    subset of the telemetry tick's device tensors plus its ``filtered``
    output."""
    samples: torch.Tensor       # busy + spares load sample
    sojourns: torch.Tensor      # head-of-claim-queue sojourn (ms)
    filtered: torch.Tensor      # FIR-filtered load (telemetry output)
    target_delay: torch.Tensor  # configured CoDel target (+inf = off)
    spares: torch.Tensor        # pool `spares` option
    maximum: torch.Tensor       # pool `maximum` option
    active: torch.Tensor        # bool: row occupied
    reset: torch.Tensor         # bool: row newly (re)assigned
    now_ms: torch.Tensor        # 0-dim f32 clock (ms)


_BOOL_INPUTS = ('active', 'reset')


def control_init(n_pools: int, epoch: int = 0, device=None) -> ControlState:
    dev = resolve_device(device)
    return ControlState(
        targets=torch.zeros((n_pools,), dtype=_F32, device=dev),
        epoch=torch.tensor(epoch, dtype=_I32, device=dev),
        now_ms=torch.zeros((), dtype=_F32, device=dev))


def control_inputs(n_pools: int, device=None, **kw) -> ControlInputs:
    """A ControlInputs of idle defaults; override any field by keyword
    with a tensor, array or number. Each field becomes float32 ([P], or
    0-dim for now_ms) on ``device``, except `active` and `reset`, which
    become bool."""
    dev = resolve_device(device)
    vals = dict(samples=0.0, sojourns=0.0, filtered=0.0,
                target_delay=float('inf'), spares=0.0, maximum=16.0,
                active=False, reset=False, now_ms=0.0)
    vals.update(kw)
    out = {}
    for name in ControlInputs._fields:
        dtype = torch.bool if name in _BOOL_INPUTS else _F32
        v = torch.as_tensor(vals[name], dtype=dtype, device=dev)
        if name != 'now_ms' and v.dim() == 0:
            v = v.expand(n_pools).clone()
        out[name] = v
    return ControlInputs(**out)


# -- the law ----------------------------------------------------------------

def _clip(x, lo, hi):
    """jnp.clip's order: lo first, then hi, so hi wins where lo > hi."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _plan_local(state: ControlState, inp: ControlInputs):
    """Per-pool pre-reduction work: resolve the carried adapted target
    and flag over-target rows."""
    base = torch.where(
        torch.isfinite(inp.target_delay)
        & (inp.target_delay >= CODEL_TARGET_MIN),
        torch.clamp_max(inp.target_delay, CODEL_TARGET_MAX), 0.0)
    has_codel = base > 0.0
    cur = torch.where(inp.reset | (state.targets <= 0.0), base,
                      state.targets)
    cur = torch.where(has_codel, cur, 0.0)
    over = inp.active & has_codel & (inp.sojourns > cur)
    return base, cur, over


def _control_sums(inp: ControlInputs, over) -> dict:
    """Reduction terms. Everything a DECISION depends on is an int32
    sum or a max; 'load' (float) feeds gauges only."""
    act = inp.active
    return {
        'n': torch.sum(act, dtype=_I32),
        'n_over': torch.sum(over, dtype=_I32),
        'load': torch.sum(torch.where(act, inp.samples, 0.0)),
        'max_sojourn': torch.max(torch.where(act, inp.sojourns, 0.0)),
    }


def _decide(state: ControlState, inp: ControlInputs,
            base, cur, over, sums: dict):
    """Post-reduction elementwise decisions on the fleet totals."""
    n = torch.clamp_min(sums['n'], 1)
    pressure = sums['n_over'].to(_F32) / n.to(_F32)
    quiet = pressure < PRESSURE_IDLE
    has_codel = base > 0.0

    # CoDel target AIMD, quantized to integer ms: tighten while over,
    # relax when this pool is below target and the fleet is quiet.
    relax = inp.active & has_codel & ~over & quiet
    t = torch.where(over, torch.floor(cur * TIGHTEN_MULT), cur)
    t = torch.where(relax, t + RELAX_STEP_MS, t)
    t = _clip(torch.round(t), t.new_tensor(CODEL_TARGET_MIN), base)
    t = torch.where(inp.active & has_codel, t, 0.0)

    # Resize plans. plan_target is the telemetry rebalance law
    # (LP-clamped shrink), rounded to a whole connection count.
    raw = inp.samples + inp.spares
    lp_min = torch.ceil(inp.filtered)
    plan = torch.where(raw < lp_min * 1.05, lp_min, raw)
    plan = torch.minimum(plan, inp.maximum)
    plan_target = to_int32_xla(torch.round(plan))
    hot = pressure >= PRESSURE_HOT
    boost = torch.where(hot & over, 1.0, 0.0)
    shed = torch.where(quiet & (inp.filtered + 1.0 < inp.spares), 1.0, 0.0)
    plan_spares = to_int32_xla(_clip(torch.round(inp.spares + boost - shed),
                                     t.new_tensor(0.0), inp.maximum))
    delta = plan_target - to_int32_xla(torch.round(raw))

    epoch = state.epoch + 1
    new_state = ControlState(targets=t, epoch=epoch, now_ms=inp.now_ms)
    decisions = {
        'codel_target': t,
        'plan_spares': plan_spares,
        'plan_target': plan_target,
        'delta': delta,
        'epoch': epoch,
    }
    fleet = {
        'n_pools': sums['n'].to(_F32),
        'pressure': pressure,
        'mean_load': sums['load'] / n.to(_F32),
        'max_sojourn': sums['max_sojourn'],
    }
    return new_state, decisions, fleet


def control_step(state: ControlState, inp: ControlInputs):
    """One control tick for the whole fleet. Returns (new_state,
    decision_columns, fleet_aggregates)."""
    base, cur, over = _plan_local(state, inp)
    sums = _control_sums(inp, over)
    return _decide(state, inp, base, cur, over, sums)


# -- regex partition rules --------------------------------------------------

def _path_str(path) -> str:
    """'/'-joined tree path: NamedTuple fields and dict keys by name,
    plain tuple items by index."""
    return '/'.join(str(k) for k in path)


def match_partition_rules(rules, tree):
    """Map a rule table of ``(regex, placement)`` pairs over a tree of
    tensors, yielding the placement tree. The first matching rule wins
    (re.search over the '/'-joined leaf path); rank-0 leaves are never
    split; an unmatched leaf raises, so a new state or decision column
    must be placed deliberately."""
    def pick(path, leaf):
        if leaf.dim() == 0:
            return ()
        name = _path_str(path)
        for rx, spec in rules:
            if re.search(rx, name):
                return spec
        raise ValueError('no partition rule matches %r' % name)
    return tree_map_with_path(pick, tree)


def partition_rules(axes: tuple = ('pools',)):
    """The ONE enumeration of how control-plane data shards: scalars
    (clock, epoch, fleet aggregates) replicate; every per-pool column
    splits over the mesh axes."""
    return (
        (r'(^|/)(now_ms|epoch|n_pools|pressure|mean_load|max_sojourn)$',
         ()),
        (r'.*', (tuple(axes),)),
    )


@functools.lru_cache(maxsize=None)
def control_specs(axes: tuple = ('pools',)):
    """(state, inputs, outputs) placement trees, derived by running the
    rule table over templates of the step made on the CPU."""
    rules = partition_rules(axes)
    state_t = control_init(8, device='cpu')
    inp_t = control_inputs(8, device='cpu')
    out_t = control_step(state_t, inp_t)
    return (match_partition_rules(rules, state_t),
            match_partition_rules(rules, inp_t),
            match_partition_rules(rules, out_t))


def _mesh_control_step(mesh: Mesh, axes: tuple, hierarchical: bool):
    """The control step over the shards of ``mesh``: ``_plan_local`` on
    each shard, the decision-feeding counts all-reduced (int32 sums and
    a max, so the decisions match the plain step bit for bit whatever
    the reduction tree), then ``_decide`` on each shard. Takes and
    returns sharded trees."""
    reducer = Reducer(mesh, axes, hierarchical)

    def step(states, inps):
        if len(states) != mesh.size or len(inps) != mesh.size:
            raise ValueError('a %d-shard step got %d states and %d inputs'
                             % (mesh.size, len(states), len(inps)))
        plans = [_plan_local(s, x) for s, x in zip(states, inps)]
        sums = reducer.terms(
            [_control_sums(x, over) for x, (_, _, over) in zip(inps, plans)],
            max_terms=('max_sojourn',))
        results = [_decide(s, x, *plan, sm) for s, x, plan, sm in
                   zip(states, inps, plans, sums)]
        return tuple(zip(*results))
    return step


def make_control_step(mesh: Mesh | None = None, axes: tuple = ('pools',)):
    """The live control step. Without a mesh, the step on one device
    (the JAX form donates its state; this one allocates the new state
    and leaves the old one intact). With a mesh, every per-pool column
    split per the partition rules, the counts reduced in one pass over
    the shards."""
    if mesh is None:
        return control_step
    return _mesh_control_step(mesh, tuple(axes), hierarchical=False)


def make_shardmap_control_step(mesh: Mesh, axes: tuple = ('pools',)):
    """The SPMD form: the counts reduced innermost mesh axis first, then
    the outer ones, as the JAX form's psum over ``reversed(axes)``."""
    return _mesh_control_step(mesh, tuple(axes), hierarchical=True)


def shard_control_state(state: ControlState, mesh: Mesh,
                        axes: tuple = ('pools',)) -> tuple:
    return shard_tree(state, control_specs(tuple(axes))[0], mesh)


def shard_control_inputs(inp: ControlInputs, mesh: Mesh,
                         axes: tuple = ('pools',)) -> tuple:
    return shard_tree(inp, control_specs(tuple(axes))[1], mesh)


# -- batched host actuation -------------------------------------------------

def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def apply_decisions(pools_by_row, decisions, at_ms=None,
                    health=None) -> dict:
    """Apply one step's decision columns to live pools.

    ``pools_by_row`` maps row index -> pool (the sampler's
    ``fs_row_pool``); ``decisions`` is the step's decision dict (device
    tensors or host arrays). Every pool is offered its row's decision
    through ``apply_control_decision``, the guarded API that validates
    the epoch and every field before mutating anything. Pools without
    the API are skipped. ``health`` (an optional fleet health citation)
    is forwarded alongside. Returns
    ``{'applied': n, 'rejected': n, 'skipped': n, 'epoch': e}``."""
    ct = _host(decisions['codel_target'])
    sp = _host(decisions['plan_spares'])
    epoch = int(_host(decisions['epoch']))
    extra = {} if health is None else {'health': health}
    applied = rejected = skipped = 0
    for row, pool in pools_by_row.items():
        apply = getattr(pool, 'apply_control_decision', None)
        if apply is None:
            skipped += 1
            continue
        target = float(ct[row])
        ok = apply(epoch,
                   codel_target=target if target > 0.0 else None,
                   spares=int(sp[row]), at_ms=at_ms, **extra)
        if ok:
            applied += 1
        else:
            rejected += 1
    return {'applied': applied, 'rejected': rejected,
            'skipped': skipped, 'epoch': epoch}


def reduce_control(records) -> dict:
    """Combine per-shard control summaries (record['control'] dicts)
    into one fleet row: counts sum, pressure/mean_load combine weighted
    by pool count, max_sojourn takes the worst shard."""
    records = [r for r in records if r]
    out = {'n_pools': 0.0, 'pressure': 0.0, 'mean_load': 0.0,
           'max_sojourn': 0.0, 'applied': 0, 'rejected': 0,
           'skipped': 0}
    if not records:
        return out
    tot = sum(float(r['fleet']['n_pools']) for r in records)
    safe = tot if tot > 0.0 else 1.0
    for r in records:
        f = r['fleet']
        w = float(f['n_pools'])
        out['n_pools'] += w
        out['pressure'] += f['pressure'] * w / safe
        out['mean_load'] += f['mean_load'] * w / safe
        out['max_sojourn'] = max(out['max_sojourn'], f['max_sojourn'])
        for k in ('applied', 'rejected', 'skipped'):
            out[k] += int(r.get(k, 0))
    return out
