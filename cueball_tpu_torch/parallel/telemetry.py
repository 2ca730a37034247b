"""Fleet telemetry step: the framework's control laws, batched over pools.

One step consumes, for every pool in a fleet, the same signals each
pool's own Python control laws see:

- a load sample (busy + spares, what the 5 Hz LP timer feeds per pool,
  reference lib/pool.js:251-262)
- the head-of-queue claim sojourn (ms) and CoDel target
- the deepest retry-backoff position among the pool's slots
  (reference lib/connection-fsm.js:361-394)
- the pool's own spares / maximum settings

and produces, per pool:

- the FIR-filtered load (128-tap EMA, reference lib/pool.js:44-100)
- the clamped rebalance target (reference lib/pool.js:573-592)
- the CoDel drop decision (reference lib/codel.js)
- the reproduced backoff delay (reference lib/connection-fsm.js:372-380)

plus fleet-wide aggregates (mean load, overload fraction, retry
pressure), which become all-reduces when the pools axis is split over
a :class:`~.mesh.Mesh` (the mesh forms at the end of this module).
Rows are a fixed-capacity [P] axis; `active` masks unoccupied rows out
of the aggregates and `reset` clears carried state when a row is
reassigned to a new pool.

Everything is float32, the clock included: ``now_ms`` is a 0-dim
float32 tensor, because CoDel compares and adds float32 timestamps and
a float64 clock decides different drops.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from .._device import resolve_device
from ..ops.backoff import backoff_at
from ..ops.codel_batch import CodelState, codel_init, _step as codel_step
from ..ops.fir import fir_apply, fir_apply_cuda, fir_apply_plain, gen_taps
from .mesh import Mesh, Reducer, shard_tree


class FleetState(typing.NamedTuple):
    windows: torch.Tensor   # [pools, taps] load sample ring (old->new)
    codel: CodelState       # [pools] CoDel control state
    now_ms: torch.Tensor    # 0-dim float32 clock of the last step


class FleetInputs(typing.NamedTuple):
    """One tick's worth of per-pool samples (all [P] unless noted)."""
    samples: torch.Tensor          # busy + spares load sample
    sojourns: torch.Tensor         # head-of-claim-queue sojourn (ms)
    target_delay: torch.Tensor     # CoDel target (ms); +inf = CoDel off
    spares: torch.Tensor           # pool `spares` option
    maximum: torch.Tensor          # pool `maximum` option
    retry_delay: torch.Tensor      # base recovery delay of deepest slot
    retry_max_delay: torch.Tensor  # its maxDelay cap
    retry_attempt: torch.Tensor    # its backoff-entry count
    n_retrying: torch.Tensor       # slots currently in backoff
    active: torch.Tensor           # bool: row occupied by a live pool
    reset: torch.Tensor            # bool: row newly (re)assigned
    now_ms: torch.Tensor           # 0-dim float32 monotonic clock (ms)


_BOOL_INPUTS = ('active', 'reset')


def fleet_init(n_pools: int, taps: int = 128, device=None) -> FleetState:
    dev = resolve_device(device)
    return FleetState(
        windows=torch.zeros((n_pools, taps), dtype=torch.float32,
                            device=dev),
        codel=codel_init(n_pools, device=dev),
        now_ms=torch.zeros((), dtype=torch.float32, device=dev))


def fleet_inputs(n_pools: int, device=None, **kw) -> FleetInputs:
    """A FleetInputs of idle defaults (inactive rows, CoDel off);
    override any field by keyword with a tensor, array or number. Each
    field becomes float32 ([P], or 0-dim for now_ms) on ``device``,
    except `active` and `reset`, which become bool."""
    dev = resolve_device(device)
    vals = dict(
        samples=0.0, sojourns=0.0, target_delay=float('inf'),
        spares=0.0, maximum=16.0, retry_delay=0.0, retry_max_delay=0.0,
        retry_attempt=0.0, n_retrying=0.0, active=False, reset=False,
        now_ms=0.0)
    vals.update(kw)
    out = {}
    for name in FleetInputs._fields:
        dtype = torch.bool if name in _BOOL_INPUTS else torch.float32
        v = torch.as_tensor(vals[name], dtype=dtype, device=dev)
        if name != 'now_ms' and v.dim() == 0:
            v = v.expand(n_pools).clone()
        out[name] = v
    return FleetInputs(**out)


def _shift_append(windows: torch.Tensor, samples: torch.Tensor,
                  reset: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Write into ``out`` (which must not overlap ``windows``) each row's
    window shifted left by one with the new sample appended; a reset row
    restarts from zeros before its new sample. The reset rides in the
    shifting copy, so the [P, K] ring is read and written once."""
    torch.where(reset[:, None], windows.new_zeros(()), windows[:, 1:],
                out=out[:, :-1])
    out[:, -1].copy_(samples)
    return out


def _local_step(state: FleetState, inp: FleetInputs, fir_fn=None,
                out_windows: torch.Tensor | None = None):
    """Per-pool control laws, embarrassingly parallel over the pools
    axis. The new window ring is written into ``out_windows`` if given
    (it must not overlap ``state.windows``), else into a new tensor."""
    if fir_fn is None:
        fir_fn = fir_apply
    rst = inp.reset
    codel0 = CodelState(
        first_above=torch.where(rst, 0.0, state.codel.first_above),
        drop_next=torch.where(rst, 0.0, state.codel.drop_next),
        count=torch.where(rst, 0.0, state.codel.count),
        dropping=state.codel.dropping & ~rst)

    if out_windows is None:
        out_windows = torch.empty_like(state.windows)
    windows = _shift_append(state.windows, inp.samples, rst, out_windows)
    taps = gen_taps(windows.shape[1], device=windows.device)
    filtered = fir_fn(windows, taps)

    # Rebalance target with LP clamp (reference lib/pool.js:573-592):
    # shrink no faster than the filtered recent load allows.
    raw_target = inp.samples + inp.spares
    lp_min = torch.ceil(filtered)
    clamped = raw_target < lp_min * 1.05
    target = torch.where(clamped, lp_min, raw_target)
    target = torch.minimum(target, inp.maximum)

    codel_state, drops = codel_step(
        inp.target_delay, codel0, (inp.now_ms, inp.sojourns))

    # Reproduced per-pool backoff delay of the deepest retrying slot
    # (reference lib/connection-fsm.js:372-380 double-and-cap ladder).
    has_retry = inp.n_retrying > 0
    retry_backoff = torch.where(
        has_retry,
        backoff_at(inp.retry_delay, inp.retry_max_delay,
                   inp.retry_attempt),
        0.0)

    new_state = FleetState(windows=windows, codel=codel_state,
                           now_ms=inp.now_ms)
    out = {'filtered': filtered, 'target': target,
           'clamped': clamped, 'drop': drops,
           'retry_backoff': retry_backoff}
    return new_state, out


def _partial_sums(inp: FleetInputs, out: dict) -> dict:
    """Reduction terms for the fleet aggregates, masked to occupied
    rows. Combined across shards by sum, except 'max_sojourn' (max)."""
    act = inp.active.to(torch.float32)
    retrying = (inp.n_retrying > 0).to(torch.float32) * act
    return {
        'n': torch.sum(act),
        'load': torch.sum(inp.samples * act),
        'filtered': torch.sum(out['filtered'] * act),
        'drops': torch.sum(out['drop'].to(torch.float32) * act),
        'n_retry': torch.sum(retrying),
        'backoff': torch.sum(out['retry_backoff'] * retrying),
        'max_sojourn': torch.max(
            torch.where(inp.active, inp.sojourns, 0.0)),
    }


def _finalize(p: dict) -> dict:
    n = torch.clamp_min(p['n'], 1.0)
    n_retry = torch.clamp_min(p['n_retry'], 1.0)
    return {
        'n_pools': p['n'],
        'mean_load': p['load'] / n,
        'mean_filtered': p['filtered'] / n,
        'overload_frac': p['drops'] / n,
        'max_sojourn': p['max_sojourn'],
        'retry_frac': p['n_retry'] / n,
        'mean_retry_backoff': p['backoff'] / n_retry,
    }


def _make_step(fir_fn=None):
    """One body for all three fleet_step variants; they differ only in
    which FIR implementation _local_step uses."""
    def step(state: FleetState, inp: FleetInputs):
        new_state, out = _local_step(state, inp, fir_fn=fir_fn)
        fleet = _finalize(_partial_sums(inp, out))
        return new_state, out, fleet
    return step


#: One telemetry tick for the whole fleet. Returns (new_state,
#: per_pool_outputs, fleet_aggregates). The FIR is the CUDA kernel for
#: tensors on the card and the plain version for tensors on the CPU.
fleet_step = _make_step()

#: fleet_step with the FIR forced onto the hand-written CUDA kernel;
#: raises for CPU tensors.
fleet_step_cuda = _make_step(fir_apply_cuda)

#: fleet_step with the FIR forced onto its plain PyTorch version.
fleet_step_plain = _make_step(fir_apply_plain)


def fleet_scan(state: FleetState, inputs: FleetInputs):
    """Run fleet_step over a whole time-window: `inputs` is a
    FleetInputs whose tensors carry a leading time axis ([T, P]; now_ms
    is [T]). Returns (final_state, per_pool_outputs stacked [T, P],
    fleet aggregates stacked [T]); the same as T fleet_step calls."""
    outs, fleets = [], []
    for t in range(inputs.now_ms.shape[0]):
        state, out, fleet = fleet_step(
            state, FleetInputs(*(f[t] for f in inputs)))
        outs.append(out)
        fleets.append(fleet)
    stack = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    stack_f = {k: torch.stack([f[k] for f in fleets]) for k in fleets[0]}
    return state, stack, stack_f


def rebase_state(state: FleetState, shift) -> FleetState:
    """Shift the CoDel timestamp clocks back by `shift` ms.

    Time is float32, so an absolute monotonic clock (~1e9 ms on a
    long-lived host) would round to ~64 ms; callers run an
    epoch-relative clock and rebase the carried state. Timestamps older
    than the shift clamp to 1 ms, which keeps both CoDel uses of an old
    timestamp (`now >= t` and `now - t >= INTERVAL`) as long as the
    post-rebase `now` stays above INTERVAL + 1. The 0 sentinel
    ("unset") is kept exactly."""
    shift = torch.as_tensor(shift, dtype=torch.float32,
                            device=state.windows.device)
    fa = state.codel.first_above
    dn = state.codel.drop_next
    return FleetState(
        windows=state.windows,
        codel=CodelState(
            first_above=torch.where(
                fa > 0.0, torch.clamp_min(fa - shift, 1.0), 0.0),
            drop_next=torch.where(
                dn > 0.0, torch.clamp_min(dn - shift, 1.0), dn),
            count=state.codel.count,
            dropping=state.codel.dropping),
        now_ms=torch.clamp_min(state.now_ms - shift, 0.0))


class LiveStep:
    """fleet_step for a caller that always replaces its state with the
    returned one, as a live sampler does: the [P, K] window ring
    ping-pongs between the window tensor of the state passed in and one
    spare of the same shape, so a tick allocates no [P, K] tensor.

    Do NOT reuse a FleetState after passing it here: its window tensor
    becomes the spare that the next tick overwrites."""

    def __init__(self):
        self._spare: torch.Tensor | None = None

    def local(self, state: FleetState, inp: FleetInputs):
        """``_local_step`` writing the new ring into the spare."""
        win = state.windows
        spare = self._spare
        if spare is None or spare.shape != win.shape or \
                spare.device != win.device or \
                spare.data_ptr() == win.data_ptr():
            spare = torch.empty_like(win)
        new_state, out = _local_step(state, inp, out_windows=spare)
        self._spare = win
        return new_state, out

    def __call__(self, state: FleetState, inp: FleetInputs):
        new_state, out = self.local(state, inp)
        return new_state, out, _finalize(_partial_sums(inp, out))


# -- the mesh forms -----------------------------------------------------------
#
# A sharded FleetState / FleetInputs is a tuple of per-shard ones
# (parallel.mesh). Every form below runs ONE per-shard body,
# _local_step -> _partial_sums -> all-reduce -> _finalize, and differs
# only in the reduction tree and in whether the ring ping-pongs.

def _step_shardings(axes: tuple = ('pools',)):
    """(state, inputs, (state, per-pool outs, aggregates)) placements
    for one fleet_step tick: the ONE table of which leaves split by
    rows over ``axes`` and which replicate. ``axes`` names the mesh
    axes the pools dimension shards over: ('pools',) on a flat mesh,
    ('host', 'chip') on a 2-D one."""
    axes = tuple(axes)
    pool = (axes,)
    scalar = ()
    state = FleetState(
        windows=(axes, None),
        codel=CodelState(pool, pool, pool, pool),
        now_ms=scalar)
    inputs = FleetInputs(
        *([pool] * (len(FleetInputs._fields) - 1)), now_ms=scalar)
    outs = (
        state,
        {'filtered': pool, 'target': pool, 'clamped': pool,
         'drop': pool, 'retry_backoff': pool},
        {'n_pools': scalar, 'mean_load': scalar, 'mean_filtered': scalar,
         'overload_frac': scalar, 'max_sojourn': scalar,
         'retry_frac': scalar, 'mean_retry_backoff': scalar})
    return state, inputs, outs


def _scan_shardings(axes: tuple = ('pools',)):
    """The [T, ...] window placements: a leading unsplit time axis in
    front of each tick placement. The final carried state has no time
    axis; the stacked outputs and aggregates do."""
    state, inputs, (_, outs, fleet) = _step_shardings(axes)
    window = FleetInputs(*((None,) + spec for spec in inputs))
    return state, window, (state,
                           {k: (None,) + v for k, v in outs.items()},
                           {k: (None,) + v for k, v in fleet.items()})


class MeshStep:
    """fleet_step over the shards of a :class:`~.mesh.Mesh`: each shard
    runs the per-pool laws on its rows (the FIR kernel launches once
    per shard on the card), and the fleet aggregates all-reduce over
    the mesh. Takes and returns sharded trees: ``(states, inputs) ->
    (states, per-pool outs, aggregates)``, each a tuple over shards.
    With ``live``, each shard ping-pongs its own ring (see
    :class:`LiveStep`)."""

    def __init__(self, mesh: Mesh, axes: tuple = ('pools',),
                 hierarchical: bool = False, live: bool = False):
        self.reducer = Reducer(mesh, axes, hierarchical)
        n = mesh.size
        self.lives = [LiveStep() for _ in range(n)] if live else None
        self.locals = ([ls.local for ls in self.lives] if live
                       else [_local_step] * n)

    def __call__(self, states, inps):
        n = len(self.locals)
        if len(states) != n or len(inps) != n:
            raise ValueError('a %d-shard step got %d states and %d inputs'
                             % (n, len(states), len(inps)))
        stepped = [local(s, x) for local, s, x in
                   zip(self.locals, states, inps)]
        totals = self.reducer.terms(
            [_partial_sums(x, out) for x, (_, out) in zip(inps, stepped)],
            max_terms=('max_sojourn',))
        return (tuple(s for s, _ in stepped), tuple(o for _, o in stepped),
                tuple(_finalize(p) for p in totals))


def make_sharded_step(mesh: Mesh, axes: tuple = ('pools',)) -> MeshStep:
    """fleet_step with every [pools, ...] tensor split over the mesh
    axes ``axes``; the aggregates reduce in one pass over the shards,
    as GSPMD's all-reduce does."""
    return MeshStep(mesh, axes)


def make_shardmap_step(mesh: Mesh, axes: tuple = ('pools',)) -> MeshStep:
    """The SPMD form of fleet_step: the aggregates reduce
    hierarchically, innermost mesh axis first (on a 2-D ('host', 'chip')
    mesh: over 'chip', then 'host'), as the JAX form's psum/pmax over
    ``reversed(axes)`` does."""
    return MeshStep(mesh, axes, hierarchical=True)


def make_live_step(mesh: Mesh | None = None, axes: tuple = ('pools',)):
    """The live runtime's per-tick step: see LiveStep. With a mesh, one
    LiveStep per shard and the aggregates reduced as in
    make_sharded_step. Each live fleet gets its own, since it owns that
    fleet's spare window buffers."""
    if mesh is None:
        return LiveStep()
    return MeshStep(mesh, axes, live=True)


def make_sharded_scan(mesh: Mesh, axes: tuple = ('pools',)):
    """fleet_scan with the pools axis split over the mesh: each shard
    carries its rows through all T ticks, the per-tick aggregates
    reduce over the mesh. Takes the sharded state and a window placed
    by :func:`shard_window`; returns (final states, per-pool outputs
    stacked [T, P/n] per shard, aggregates stacked [T] per shard)."""
    step = MeshStep(mesh, axes)

    def scan(states, windows):
        outs, fleets = [], []
        for t in range(windows[0].now_ms.shape[0]):
            states, out, fleet = step(
                states, tuple(FleetInputs(*(f[t] for f in w))
                              for w in windows))
            outs.append(out)
            fleets.append(fleet)

        def stack(per_tick, i):
            return {k: torch.stack([tick[i][k] for tick in per_tick])
                    for k in per_tick[0][i]}
        n = len(states)
        return (states, tuple(stack(outs, i) for i in range(n)),
                tuple(stack(fleets, i) for i in range(n)))
    return scan


def shard_state(state: FleetState, mesh: Mesh,
                axes: tuple = ('pools',)) -> tuple:
    return shard_tree(state, _step_shardings(axes)[0], mesh)


def shard_inputs(inp: FleetInputs, mesh: Mesh,
                 axes: tuple = ('pools',)) -> tuple:
    return shard_tree(inp, _step_shardings(axes)[1], mesh)


def shard_window(window: FleetInputs, mesh: Mesh,
                 axes: tuple = ('pools',)) -> tuple:
    """Place a [T, P] tick window onto the mesh (pools axis split)."""
    return shard_tree(window, _scan_shardings(axes)[1], mesh)


def fold_backend_slots(cols: dict, rows: int) -> dict:
    """Fold drained per-backend slot columns into step-shaped arrays.

    ``cols`` maps a column name to a host numpy column indexed by
    backend row: rank-1 accumulators and rank-2 ``*_buckets`` sketches.
    The backend axis pads with zeros out to ``rows``; the bucket axis of
    rank-2 columns is fixed geometry and never pads."""
    out = {}
    for name, col in cols.items():
        pad = rows - len(col)
        if col.ndim == 1:
            out[name] = np.pad(col, (0, pad))
        else:
            out[name] = np.pad(col, ((0, pad), (0, 0)))
    return out
