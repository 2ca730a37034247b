"""Live bridge: registered pools -> the batched telemetry step, on one
device or split over a :class:`~.mesh.Mesh` (``options['mesh']``), the
counterpart of ``cueball_tpu.parallel.sampler``.

Every tick the FleetSampler feeds, for every pool registered in its
monitor, exactly the signals the pool's own control laws consume:

- the LP load sample ``busy + spares`` (``pool.lp_load_sample()``),
- the head-of-claim-queue sojourn and CoDel target,
- the deepest slot backoff position (the SocketMgr ladder),

runs the live telemetry step (``make_live_step``: the FIR is the
hand-written CUDA kernel on the card) over the whole fleet at once,
and publishes the per-pool outputs and fleet aggregates through its
snapshot and the ``cueball_fleet_*`` gauges. With ``control`` it then
runs the control step on the tick's own device tensors; with
``health`` it ticks a HealthMonitor in step.

Rows: pools get stable rows in fixed-capacity columns (capacity
doubles as the fleet grows); departed pools free their row and the
`reset` mask clears carried filter/CoDel state when a row is
reassigned.

The roster: the occupied rows in assignment order, their pools and the
pools' advisory and control entry points, bound once. It is rebuilt
only when the row -> pool map changes (``fs_roster_builds`` counts the
builds; ``snapshot()['roster_builds']``), so a steady tick walks the
advisories and decisions over cached columns: one ``tolist`` per
column and a call per warm pool. Each row's ticks since its reset are
the integer column ``fs_row_ticks``, advanced with one add a tick; a
row is warm, and offered advisories and decisions, once its count
reaches ``taps``.

Incremental gather: the per-pool signals live in numpy columns owned
by the sampler, maintained event-driven. On row assignment the pool
receives a :class:`TelemetryRowHandle`; the pool calls
``mark_dirty()`` whenever a gathered signal can move, and
``sample_once`` re-reads only the dirty rows. Pools without the push
protocol (no ``telemetry_attach``) are re-gathered every tick.

The process-wide host state (clock, recurring timer, backend registry
and sinks, metrics collector, loop-lag sampler) is reached through
``options['host']``, by default ``cueball_tpu_torch.host``.
"""

from __future__ import annotations

import heapq
import itertools
import math
import threading
import weakref
from collections.abc import Mapping
from itertools import compress

import numpy as np
import torch

from .. import host as default_host
from .._device import resolve_device, to_host_values
from ..events import EventEmitter
from ..monitor import pool_monitor as default_monitor
from ..ops.codel_batch import CodelState
from .control import (ControlInputs, RowPools, apply_decisions,
                      control_init, make_control_step, shard_control_state)
from .health import HealthMonitor
from .mesh import Mesh, Reducer, shard_rows, unshard
from .telemetry import (FleetInputs, FleetState, fleet_init,
                        make_live_step, rebase_state, shard_state)

SAMPLER_INT = 200  # ms, the pools' own LP cadence

# Rebase the epoch-relative clock before float32 resolution decays:
# at 2^20 ms (~17 min) the f32 ulp is 0.0625 ms, ample for the 100 ms
# CoDel control interval. MARGIN keeps post-rebase `now` large enough
# that clamped-stale timestamps keep their "very old" semantics.
EPOCH_LIMIT = float(2 ** 20)
EPOCH_MARGIN = 1000.0

# Samplers created and not yet stopped, by creation order: the SIGUSR2
# dump (``debug.dump_fleet_runtime``) lists them. Weak, so a sampler
# dropped without stop() leaves the list.
_SAMPLERS: weakref.WeakValueDictionary = weakref.WeakValueDictionary()
_SAMPLERS_LOCK = threading.Lock()
_SAMPLER_SEQ = itertools.count()


def active_samplers() -> list:
    """Every FleetSampler of this process not yet stopped, oldest
    first."""
    with _SAMPLERS_LOCK:
        return [s for _, s in sorted(_SAMPLERS.items())]


_CONTROL_GAUGES = {
    'pressure': 'fleet overload fraction seen by the control step',
    'mean_load': 'mean busy+spares load seen by the control step',
    'applied': 'control decisions accepted by pools last step',
    'rejected': 'control decisions rejected by pools last step',
    'epoch': 'decision epoch of the last control step',
    'step_ms': 'host-side duration of the last control step (ms)',
}

_FLEET_GAUGES = {
    'n_pools': 'pools currently sampled into the fleet step',
    'mean_load': 'mean busy+spares load across the fleet',
    'mean_filtered': 'mean FIR-filtered load across the fleet',
    'overload_frac': 'fraction of pools with a CoDel drop this tick',
    'max_sojourn': 'worst head-of-queue claim sojourn (ms)',
    'retry_frac': 'fraction of pools with slots in retry backoff',
    'mean_retry_backoff': 'mean reproduced backoff delay (ms)',
    'loop_lag_p99_us': 'worst observed event-loop callback lag p99 '
                       '(us, loop-lag sampler; 0 when unarmed)',
}

# Per-row defaults for the event-maintained signal columns: the values
# an unoccupied (or just-released) row carries. target_delay=inf means
# "CoDel off" in the batched law.
_COL_DEFAULTS = {
    'samples': 0.0,
    'target_delay': math.inf,
    'spares': 0.0,
    'maximum': 0.0,
    'retry_delay': 0.0,
    'retry_max_delay': 0.0,
    'retry_attempt': 0.0,
    'n_retrying': 0.0,
}


class TelemetryRowHandle:
    """A pool's write capability into its sampler's dirty set.

    Handed to the pool at row assignment (``pool.telemetry_attach``).
    ``mark_dirty()`` is the whole push protocol: one set-add, no
    payload. ``detach()`` (called when the row is freed) turns the
    handle inert."""

    __slots__ = ('th_row', 'th_dirty')

    def __init__(self, row: int, dirty: set):
        self.th_row = row
        self.th_dirty = dirty

    def mark_dirty(self) -> None:
        d = self.th_dirty
        if d is not None:
            d.add(self.th_row)

    def detach(self) -> None:
        self.th_dirty = None


class _TickPools(Mapping):
    """Lazy per-pool view of one tick's record: a pool's entry is built
    only when someone reads it. The backing arrays are the tick's own
    copies, so the view stays frozen as the live columns move on."""

    __slots__ = ('tp_rows', 'tp_cols', 'tp_out')

    def __init__(self, rows: dict, cols: dict, out: dict):
        self.tp_rows = rows
        self.tp_cols = cols
        self.tp_out = out

    def __len__(self):
        return len(self.tp_rows)

    def __iter__(self):
        return iter(self.tp_rows)

    def __contains__(self, uuid):
        return uuid in self.tp_rows

    def __getitem__(self, uuid):
        row = self.tp_rows[uuid]
        cols = self.tp_cols
        out = self.tp_out
        # target_delay=inf means "CoDel off"; publish None instead
        # (Infinity is not valid JSON).
        td = float(cols['target_delay'][row])
        return {
            'row': row,
            'inputs': {
                'sample': float(cols['samples'][row]),
                'sojourn': float(cols['sojourns'][row]),
                'target_delay': td if math.isfinite(td) else None,
                'spares': float(cols['spares'][row]),
                'maximum': float(cols['maximum'][row]),
                'retry_delay': float(cols['retry_delay'][row]),
                'retry_max_delay': float(cols['retry_max_delay'][row]),
                'retry_attempt': float(cols['retry_attempt'][row]),
                'n_retrying': float(cols['n_retrying'][row]),
            },
            'filtered': float(out['filtered'][row]),
            'target': float(out['target'][row]),
            'clamped': bool(out['clamped'][row]),
            'drop': bool(out['drop'][row]),
            'retry_backoff': float(out['retry_backoff'][row]),
        }


class _Roster:
    """The sampler's occupied rows as columns, in ``fs_row_pool``'s
    order (the order the pools are offered): the rows as int64, the
    pools, each pool's bound ``receive_fleet_advisory`` and
    ``apply_control_decision`` (or None), a mask of the pools that take
    advisories, and a frozen uuid -> row map for the tick records.
    Built when the row -> pool map changes; :meth:`warm` caches the
    selection of the last warm mask."""

    __slots__ = ('ro_rows', 'ro_pools', 'ro_receive', 'ro_apply',
                 'ro_has_receive', 'ro_row_map', 'ro_warm_mask', 'ro_warm')

    def __init__(self, row_pool: dict, rows: dict):
        pools = list(row_pool.values())
        self.ro_rows = np.fromiter(row_pool, np.int64, len(pools))
        self.ro_pools = pools
        self.ro_receive = [getattr(p, 'receive_fleet_advisory', None)
                           for p in pools]
        self.ro_apply = [getattr(p, 'apply_control_decision', None)
                         for p in pools]
        self.ro_has_receive = np.fromiter(
            (f is not None for f in self.ro_receive), bool, len(pools))
        self.ro_row_map = dict(rows)   # never mutated: records share it
        self.ro_warm_mask = None
        self.ro_warm = None

    def warm(self, mask: np.ndarray) -> tuple:
        """For the warm rows ``mask`` selects: the rows whose pools
        take advisories, their bound ``receive_fleet_advisory``, and a
        :class:`~.control.RowPools` of every warm row for the control's
        offer. Reused while the mask stays the same."""
        last = self.ro_warm_mask
        if last is None or not np.array_equal(last, mask):
            take = mask.tolist()
            advise = mask & self.ro_has_receive
            self.ro_warm = (
                self.ro_rows[advise],
                list(compress(self.ro_receive, advise.tolist())),
                RowPools(dict(zip(self.ro_rows[mask].tolist(),
                                  compress(self.ro_pools, take))),
                         list(compress(self.ro_apply, take))))
            self.ro_warm_mask = mask
        return self.ro_warm


def _control_inputs(inp: FleetInputs, out: dict) -> ControlInputs:
    """The control step's inputs: the telemetry tick's own device
    tensors and its ``filtered`` output, nothing shipped anew."""
    return ControlInputs(
        samples=inp.samples, sojourns=inp.sojourns,
        filtered=out['filtered'], target_delay=inp.target_delay,
        spares=inp.spares, maximum=inp.maximum,
        active=inp.active, reset=inp.reset, now_ms=inp.now_ms)


def _pad_rows(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``t`` with ``pad`` zero rows appended along its first axis."""
    return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])


class FleetSampler:
    """Samples every registered pool into the batched telemetry step.

    Options (all optional):
    - monitor: a pool registry with ``pm_pools`` (default: the
      process-wide ``cueball_tpu_torch.monitor.pool_monitor``)
    - interval: tick period in ms (default 200 = the LP cadence)
    - taps: FIR window length (default 128, the pool's own filter)
    - capacity: initial row capacity (default 8; grows by doubling)
    - collector: a metrics Collector to publish cueball_fleet_* gauges
    - record: keep a per-tick history of inputs/outputs (for tests)
    - actuate: push each tick's filtered load back into the sampled
      pools (``receive_fleet_advisory``) once a row's window is full.
    - shard: a shard id; only pools whose ``p_shard`` matches are
      sampled, and the gauges carry a ``shard`` label.
    - control: run the control step after every telemetry tick and
      offer its decision columns to the sampled pools through
      ``apply_control_decision``. Rows inside the FIR warm-up window
      (< taps ticks) are not offered decisions. The tick record gains
      a ``control`` entry.
    - health: run a HealthMonitor after every telemetry tick, fed by
      the host's backend sinks. The tick record gains a ``health``
      entry with the verdict record.
    - objectives: an SLOObjectives for the health monitor.
    - host: the host seam (see ``cueball_tpu_torch.host``).
    - device: where the fleet tensors live (default CUDA, which must
      exist; ``'cpu'`` runs the plain FIR).
    - mesh: a :class:`~.mesh.Mesh`. The fleet tensors then live split
      by rows over the mesh's devices (``device`` is not read), the
      tick runs the per-shard step (one FIR launch per shard) with the
      aggregates all-reduced, and the control and health steps run
      sharded too. Row capacity rounds up to a multiple of the mesh
      size. The snapshot reports the mesh.
    - meshAxes: the mesh axes the pools axis splits over (default
      ('pools',); ('host', 'chip') for a 2-D mesh).
    """

    def __init__(self, options: dict | None = None):
        options = options or {}
        self.fs_mesh: Mesh | None = options.get('mesh')
        self.fs_mesh_axes = tuple(options.get('meshAxes') or ('pools',))
        self.fs_device = (self.fs_mesh.first_device
                          if self.fs_mesh is not None
                          else resolve_device(options.get('device')))
        self.fs_host = options.get('host') or default_host
        self.fs_monitor = options.get('monitor') or default_monitor
        self.fs_shard = options.get('shard')
        self.fs_interval = options.get('interval') or SAMPLER_INT
        self.fs_taps = options.get('taps') or 128
        self.fs_capacity = options.get('capacity') or 8
        if self.fs_mesh is not None:
            # Rows split evenly over the shards; doubling growth keeps
            # any starting multiple.
            n = self.fs_mesh.size
            self.fs_capacity = -(-self.fs_capacity // n) * n
        self.fs_collector = options.get('collector')
        self.fs_record = bool(options.get('record'))
        self.fs_actuate = bool(options.get('actuate'))
        self.fs_step = None                    # live tick step (lazy)
        self.fs_input_cache: dict[str, tuple] = {}  # field -> (host, dev)
        self.fs_control = bool(options.get('control'))
        self.fs_ctrl_state = None              # ControlState (lazy)
        self.fs_ctrl_step = None               # control step
        self.fs_ctrl_last: dict | None = None  # last control record
        self.fs_health = bool(options.get('health'))
        self.fs_objectives = options.get('objectives')
        self.fs_health_monitor = None          # HealthMonitor (lazy)

        self.fs_epoch = self.fs_host.current_millis()
        self.fs_rows: dict[str, int] = {}      # pool uuid -> row
        self.fs_row_pool: dict[int, object] = {}  # row -> pool (live)
        # Ticks since each row's reset; -1 on a row never assigned.
        self.fs_row_ticks = np.full((self.fs_capacity,), -1, np.int64)
        self.fs_roster: _Roster | None = None  # rebuilt on a map change
        self.fs_roster_builds = 0
        self.fs_free: list[int] = list(range(self.fs_capacity))  # heap
        self.fs_pending_reset: set[int] = set()

        # Event-maintained signal columns. The dirty set is SHARED with
        # every handle this sampler hands out; sample_once drains it in
        # place (never rebinds it).
        self.fs_dirty: set[int] = set()
        self.fs_polled: set[int] = set()   # rows re-gathered every tick
        self.fs_handles: dict[int, TelemetryRowHandle] = {}
        self.fs_tick_visits = 0       # rows re-gathered last tick
        self.fs_gather_visits = 0     # cumulative, for regression tests
        self._alloc_columns(self.fs_capacity)

        # Roster generation last reconciled (monitors without the
        # counter reconcile every tick).
        self.fs_monitor_gen: object = object()

        self.fs_state = None                   # FleetState (lazy)
        self.fs_latest: dict | None = None
        self.fs_history: list[dict] = []
        self.fs_ticks = 0
        self.fs_timer = None
        self.fs_emitter = EventEmitter()
        self.fs_emitter.on('timeout', self.sample_once)
        self.fs_seq = next(_SAMPLER_SEQ)
        with _SAMPLERS_LOCK:
            _SAMPLERS[self.fs_seq] = self

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        """Run one synchronous tick (which builds the state and, on the
        card, the FIR kernel), then tick on the running asyncio loop."""
        if self.fs_timer is not None:
            return
        self.sample_once()
        self.fs_timer = self.fs_host._Interval(self.fs_interval,
                                               self.fs_emitter)

    def stop(self) -> None:
        with _SAMPLERS_LOCK:
            _SAMPLERS.pop(self.fs_seq, None)
        if self.fs_timer is not None:
            self.fs_timer.cancel()
            self.fs_timer = None
        if self.fs_health_monitor is not None:
            self.fs_health_monitor.stop()
            self.fs_health_monitor = None

    # -- row management --------------------------------------------------

    def _alloc_columns(self, cap: int) -> None:
        self.fs_cols = {
            name: np.full((cap,), default, np.float32)
            for name, default in _COL_DEFAULTS.items()}
        # Head-of-queue enqueue instant, absolute ms (0 = no waiter).
        # float64: absolute ms do not fit f32; the sojourn subtraction
        # happens in f64 and only the result narrows.
        self.fs_head_ts = np.zeros((cap,), np.float64)
        # Loop-lag p99 (us) of the loop serving each row's pool: a
        # host-side column that rides the fleet row, never the step.
        self.fs_loop_lag = np.zeros((cap,), np.float64)
        self.fs_active = np.zeros((cap,), bool)

    def _ensure_state(self):
        """The carried FleetState: one tree, or with a mesh a tuple of
        per-shard trees."""
        if self.fs_state is None:
            st = fleet_init(self.fs_capacity, taps=self.fs_taps,
                            device=self.fs_device)
            if self.fs_mesh is not None:
                st = shard_state(st, self.fs_mesh, self.fs_mesh_axes)
            self.fs_state = st
            # Each sampler owns its live step: it keeps the fleet's
            # spare window buffers.
            self.fs_step = make_live_step(self.fs_mesh, self.fs_mesh_axes)
        return self.fs_state

    def _grow(self, need: int) -> None:
        old = self.fs_capacity
        cap = old
        while cap < need:
            cap *= 2
        mesh, axes = self.fs_mesh, self.fs_mesh_axes
        st = self._ensure_state()
        if mesh is not None:
            st = unshard(st)      # rows move between shards as P grows
        pad = cap - old
        st = FleetState(
            windows=_pad_rows(st.windows, pad),
            codel=CodelState(*(_pad_rows(c, pad) for c in st.codel)),
            now_ms=st.now_ms)
        self.fs_state = (st if mesh is None
                         else shard_state(st, mesh, axes))
        if self.fs_ctrl_state is not None:
            cs = self.fs_ctrl_state
            if mesh is not None:
                cs = unshard(cs)
            cs = cs._replace(targets=_pad_rows(cs.targets, pad))
            self.fs_ctrl_state = (cs if mesh is None
                                  else shard_control_state(cs, mesh, axes))
        self.fs_input_cache.clear()   # shapes changed
        for name, arr in self.fs_cols.items():
            grown = np.full((cap,), _COL_DEFAULTS[name], np.float32)
            grown[:old] = arr
            self.fs_cols[name] = grown
        self.fs_head_ts = np.pad(self.fs_head_ts, (0, pad))
        self.fs_loop_lag = np.pad(self.fs_loop_lag, (0, pad))
        self.fs_active = np.pad(self.fs_active, (0, pad))
        self.fs_row_ticks = np.pad(self.fs_row_ticks, (0, pad),
                                   constant_values=-1)
        self.fs_roster = None
        self.fs_free.extend(range(old, cap))
        heapq.heapify(self.fs_free)
        self.fs_capacity = cap

    def _attach_row(self, pool, row: int) -> None:
        handle = TelemetryRowHandle(row, self.fs_dirty)
        self.fs_handles[row] = handle
        self.fs_row_pool[row] = pool
        self.fs_roster = None
        attach = getattr(pool, 'telemetry_attach', None)
        if attach is not None:
            attach(handle)
            self.fs_dirty.add(row)     # first gather
        else:
            # No push support: this row is re-gathered every tick.
            self.fs_polled.add(row)

    def _release_row(self, row: int) -> None:
        pool = self.fs_row_pool.pop(row, None)
        self.fs_roster = None
        handle = self.fs_handles.pop(row, None)
        if handle is not None:
            handle.detach()
            detach = getattr(pool, 'telemetry_detach', None)
            if detach is not None:
                detach(handle)
        self.fs_polled.discard(row)
        self.fs_dirty.discard(row)
        for name, arr in self.fs_cols.items():
            arr[row] = _COL_DEFAULTS[name]
        self.fs_head_ts[row] = 0.0
        self.fs_loop_lag[row] = 0.0
        self.fs_active[row] = False

    def _assign_rows(self, pools: Mapping) -> None:
        for uuid in [u for u in self.fs_rows if u not in pools]:
            row = self.fs_rows.pop(uuid)
            self._release_row(row)
            heapq.heappush(self.fs_free, row)
        fresh = [u for u in pools if u not in self.fs_rows]
        if len(self.fs_rows) + len(fresh) > self.fs_capacity:
            self._grow(len(self.fs_rows) + len(fresh))
        for uuid in fresh:
            row = heapq.heappop(self.fs_free)
            self.fs_rows[uuid] = row
            self.fs_pending_reset.add(row)
            self.fs_row_ticks[row] = 0
            self.fs_active[row] = True
            self._attach_row(pools[uuid], row)

    def _current_roster(self) -> _Roster:
        """The roster of the current row -> pool map, built if the map
        changed since the last build."""
        roster = self.fs_roster
        if roster is None:
            roster = self.fs_roster = _Roster(self.fs_row_pool,
                                              self.fs_rows)
            self.fs_roster_builds += 1
        return roster

    # -- gathering -------------------------------------------------------

    @staticmethod
    def gather_pool_signals(pool) -> dict:
        """One pool's time-independent tick signals, using the pools'
        own formulas: the single source of truth for both the
        incremental columns and the :meth:`gather_pool` oracle.

        sample: the pool's LP load sample (busy + spares). head_ts: the
        first still-waiting claim's enqueue instant (absolute ms; 0.0 =
        empty queue). retry_*: the deepest backoff slot's ladder
        position, from which the batched law reproduces its delay."""
        sample = pool.lp_load_sample()

        head_ts = 0.0
        for hdl in pool.p_waiters:
            if hdl.is_in_state('waiting'):
                head_ts = float(hdl.ch_started)
                break

        target_delay = math.inf
        if pool.p_codel is not None:
            target_delay = float(pool.p_codel.cd_targdelay)

        n_retrying = 0
        attempt = 0.0
        delay0 = 0.0
        max_delay = 0.0
        for slots in pool.p_connections.values():
            for slot in slots:
                smgr = slot.get_socket_mgr()
                if not smgr.is_in_state('backoff'):
                    continue
                if not math.isfinite(smgr.sm_retries):
                    continue  # monitor slots: pinned, not a ladder
                n_retrying += 1
                a = float(smgr.sm_retries - smgr.sm_retries_left)
                if a >= attempt:
                    attempt = a
                    delay0 = float(smgr.sm_min_delay)
                    max_delay = float(smgr.sm_max_delay)
        return {
            'sample': float(sample), 'head_ts': head_ts,
            'target_delay': target_delay,
            'spares': float(pool.p_spares),
            'maximum': float(pool.p_max),
            'retry_delay': delay0, 'retry_max_delay': max_delay,
            'retry_attempt': attempt, 'n_retrying': float(n_retrying),
        }

    @staticmethod
    def gather_pool(pool, now: float) -> dict:
        """The oracle: one pool's tick signals gathered fresh, sojourn
        included. The incremental columns must agree with it."""
        g = FleetSampler.gather_pool_signals(pool)
        head_ts = g.pop('head_ts')
        g['sojourn'] = float(now - head_ts) if head_ts else 0.0
        return {'sample': g.pop('sample'), 'sojourn': g.pop('sojourn'),
                **g}

    def _patch_dirty_rows(self) -> None:
        """Re-read signals for every row whose pool reported an event
        since the last tick (plus the polled rows)."""
        patch = self.fs_dirty
        patch.update(self.fs_polled)
        self.fs_tick_visits = len(patch)
        self.fs_gather_visits += len(patch)
        if not patch:
            return
        cols = self.fs_cols
        head = self.fs_head_ts
        lag_col = self.fs_loop_lag
        row_pool = self.fs_row_pool
        # One loop-lag read per patch pass: every row this sampler
        # touches lives on the loop this pass runs on.
        loop_lag = self.fs_host.loop_lag_p99_us()
        for row in patch:
            pool = row_pool.get(row)
            if pool is None:
                continue   # freed after the mark; row already reset
            g = self.gather_pool_signals(pool)
            head[row] = g['head_ts']
            lag_col[row] = loop_lag
            cols['samples'][row] = g['sample']
            cols['target_delay'][row] = g['target_delay']
            cols['spares'][row] = g['spares']
            cols['maximum'][row] = g['maximum']
            cols['retry_delay'][row] = g['retry_delay']
            cols['retry_max_delay'][row] = g['retry_max_delay']
            cols['retry_attempt'][row] = g['retry_attempt']
            cols['n_retrying'][row] = g['n_retrying']
        # In-place clear: the handles hold this very set object.
        patch.clear()

    def gather_once(self) -> int:
        """Run one incremental host gather outside a full tick. Returns
        the number of rows visited."""
        self._patch_dirty_rows()
        return self.fs_tick_visits

    def _place_inputs(self, arrays: dict, now: float):
        """Host tick columns -> device FleetInputs, copying to the
        device only the fields whose values changed since the previous
        tick; an unchanged field reuses its cached device tensor(s).
        With a mesh, a changed column ships one slice per shard, and
        the result is a tuple of per-shard FleetInputs. The clock
        always ships, as a 0-dim float32 tensor. Callers pass per-tick
        copies, never the live columns: the cache keeps the host array
        it committed."""
        dev = self.fs_device
        devs = (None if self.fs_mesh is None
                else self.fs_mesh.shard_devices(self.fs_mesh_axes))
        placed = {}
        for name, host in arrays.items():
            cached = self.fs_input_cache.get(name)
            if cached is not None and np.array_equal(cached[0], host):
                placed[name] = cached[1]
                continue
            if devs is None:
                t = torch.tensor(host, device=dev)
            else:
                t = tuple(torch.tensor(block, device=d) for block, d in
                          zip(np.split(host, len(devs)), devs))
            self.fs_input_cache[name] = (host, t)
            placed[name] = t
        clock = torch.tensor(now, dtype=torch.float32, device=dev)
        if devs is None:
            return FleetInputs(now_ms=clock, **placed)
        return tuple(
            FleetInputs(now_ms=clock.to(d),
                        **{k: v[i] for k, v in placed.items()})
            for i, d in enumerate(devs))

    def _host_columns(self, cols: dict) -> dict:
        """A step's column outputs as numpy, one device-to-host copy per
        column (per shard, with a mesh)."""
        if self.fs_mesh is not None:
            cols = unshard(cols, device='cpu')
        return {k: v.cpu().numpy() for k, v in cols.items()}

    def _host_row(self, fleet) -> dict:
        """A step's replicated aggregates as Python numbers, in one
        device-to-host copy (shard 0's, with a mesh)."""
        return to_host_values(fleet[0] if self.fs_mesh is not None
                              else fleet)

    def sample_once(self) -> dict | None:
        """One synchronous tick: patch dirty rows, step, publish.
        Returns the published record."""
        monitor = self.fs_monitor
        gen = getattr(monitor, 'pm_generation', None)
        if gen is None or gen != self.fs_monitor_gen:
            pools = monitor.pm_pools
            if self.fs_shard is not None:
                pools = {u: p for u, p in pools.items()
                         if getattr(p, 'p_shard', None) == self.fs_shard}
            self._assign_rows(pools)
            self.fs_monitor_gen = gen
        abs_now = self.fs_host.current_millis()
        now = abs_now - self.fs_epoch
        if now > EPOCH_LIMIT:
            shift = now - EPOCH_MARGIN
            st = self._ensure_state()
            self.fs_state = (
                rebase_state(st, shift) if self.fs_mesh is None
                else tuple(rebase_state(s, shift) for s in st))
            self.fs_epoch += shift
            now -= shift
        cap = self.fs_capacity

        self._patch_dirty_rows()

        # The always-moving piece, vectorized over the column: the
        # head-of-queue sojourn every occupied row with a waiter sees.
        head = self.fs_head_ts
        sojourns = np.where(
            head > 0.0, abs_now - head, 0.0).astype(np.float32)

        reset = np.zeros((cap,), bool)
        reset[list(self.fs_pending_reset)] = True
        self.fs_pending_reset.clear()

        # Per-tick snapshots: the transfer cache commits these, and the
        # published record keeps reading them after the columns move.
        arrays = {name: col.copy() for name, col in self.fs_cols.items()}
        arrays['sojourns'] = sojourns
        arrays['active'] = self.fs_active.copy()
        arrays['reset'] = reset

        state = self._ensure_state()
        inp = self._place_inputs(arrays, now)
        try:
            new_state, out, fleet = self.fs_step(state, inp)
        except Exception:
            # The JAX step donates the carried buffers, so after a
            # failure it cannot retry against them. Recover the same
            # way, so both packages' records agree: drop the state
            # (re-init next tick), flag every occupied row for reset,
            # restart the warm-up gates; then let the error propagate.
            self.fs_state = None
            self.fs_input_cache.clear()
            rows = self._current_roster().ro_rows
            self.fs_pending_reset.update(rows.tolist())
            self.fs_row_ticks[rows] = 0
            raise
        self.fs_state = new_state
        self.fs_ticks += 1

        # One device-to-host copy for the aggregates, one per output.
        fleet_np = self._host_row(fleet)
        # Host-side column: worst loop-lag p99 across occupied rows.
        fleet_np['loop_lag_p99_us'] = (
            float(self.fs_loop_lag[self.fs_active].max())
            if bool(self.fs_active.any()) else 0.0)
        out_np = self._host_columns(out)
        roster = self._current_roster()
        per_pool = _TickPools(roster.ro_row_map, arrays, out_np)
        # Per-row tick counters drive the warm-up gates of the advisory
        # push and the control step: a row's filter starts zeroed on
        # (re)assign and under-reads for its first `taps` ticks.
        rows = roster.ro_rows
        ticks = self.fs_row_ticks
        ticks[rows] += 1
        advised, receivers, warm = roster.warm(ticks[rows] >= self.fs_taps)
        if self.fs_actuate:
            filtered = out_np['filtered'][advised].tolist()
            for receive, value in zip(receivers, filtered):
                receive(value, abs_now)

        record = {'tick': self.fs_ticks, 'now_ms': now,
                  'fleet': fleet_np, 'pools': per_pool}
        if self.fs_control:
            record['control'] = self._control_once(inp, out, abs_now, warm)
        if self.fs_health:
            record['health'] = self._health_once(abs_now)
        if self.fs_record:
            # History holds plain data: tests diff whole records.
            record['pools'] = dict(per_pool)
        self.fs_latest = record
        if self.fs_record:
            self.fs_history.append(record)
        collector = self.fs_collector
        if collector is None:
            collector = self.fs_host.active_collector()
        if collector is not None:
            labels = ({'shard': str(self.fs_shard)}
                      if self.fs_shard is not None else None)
            for name, help_ in _FLEET_GAUGES.items():
                collector.gauge(
                    'cueball_fleet_' + name, help_).set(
                        fleet_np[name], labels)
        return record

    # -- control plane ---------------------------------------------------

    def _ensure_control(self):
        if self.fs_ctrl_state is None:
            cs = control_init(self.fs_capacity, device=self.fs_device)
            if self.fs_mesh is not None:
                cs = shard_control_state(cs, self.fs_mesh,
                                         self.fs_mesh_axes)
            self.fs_ctrl_state = cs
            self.fs_ctrl_step = make_control_step(self.fs_mesh,
                                                  self.fs_mesh_axes)
        return self.fs_ctrl_state

    def _control_once(self, inp, out, abs_now: float,
                      warm: RowPools) -> dict:
        """Run the control step on the telemetry tick's device tensors
        and offer the decision columns to the pools of the ``warm``
        rows: only rows whose FIR window is fully populated. Every
        ControlInputs field is a FleetInputs tensor the tick already
        placed or the telemetry step's own ``filtered`` output; only the
        decision columns come back to the host."""
        host = self.fs_host
        t0 = host.current_millis()
        state = self._ensure_control()
        if self.fs_mesh is None:
            cinp = _control_inputs(inp, out)
        else:
            cinp = tuple(map(_control_inputs, inp, out))
        try:
            new_state, decisions, fleet = self.fs_ctrl_step(state, cinp)
        except Exception:
            # Same recovery as the JAX sampler: re-init (the epoch
            # restarts).
            self.fs_ctrl_state = None
            raise
        self.fs_ctrl_state = new_state
        dec_np = self._host_columns(decisions)
        fleet_np = self._host_row(fleet)
        # Health citation: the verdict the control plane saw when it
        # decided (the health tick runs after control, so the previous
        # tick's).
        health = None
        if self.fs_health and self.fs_health_monitor is not None:
            last = self.fs_health_monitor.hm_last
            if last is not None:
                health = {'epoch': last['epoch'],
                          'at_ms': last['at_ms'],
                          'gray': list(last['gray']),
                          'burn_fast': last['fleet']['burn_fast'],
                          'burn_slow': last['fleet']['burn_slow']}
        summary = apply_decisions(warm, dec_np, at_ms=abs_now,
                                  health=health)
        record = {'fleet': fleet_np, 'decisions': dec_np,
                  'step_ms': host.current_millis() - t0}
        record.update(summary)
        self.fs_ctrl_last = record
        collector = self.fs_collector
        if collector is None:
            collector = host.active_collector()
        if collector is not None:
            labels = ({'shard': str(self.fs_shard)}
                      if self.fs_shard is not None else None)
            vals = {'pressure': fleet_np['pressure'],
                    'mean_load': fleet_np['mean_load'],
                    'applied': summary['applied'],
                    'rejected': summary['rejected'],
                    'epoch': summary['epoch'],
                    'step_ms': record['step_ms']}
            for name, help_ in _CONTROL_GAUGES.items():
                collector.gauge('cueball_control_' + name, help_).set(
                    float(vals[name]), labels)
        return record

    # -- health plane ----------------------------------------------------

    def _ensure_health(self) -> HealthMonitor:
        if self.fs_health_monitor is None:
            opts = {'collector': self.fs_collector,
                    'shard': self.fs_shard,
                    'interval': self.fs_interval,
                    'host': self.fs_host,
                    'device': self.fs_device}
            if self.fs_mesh is not None:
                opts['mesh'] = self.fs_mesh
                opts['meshAxes'] = self.fs_mesh_axes
            if self.fs_objectives is not None:
                opts['objectives'] = self.fs_objectives
            # start() attaches the monitor's BackendTable to the host's
            # backend sinks.
            self.fs_health_monitor = HealthMonitor(opts).start()
        return self.fs_health_monitor

    def _health_once(self, abs_now: float) -> dict:
        """Tick the owned HealthMonitor in step with the fleet tick."""
        return self._ensure_health().tick(abs_now)

    # -- snapshot --------------------------------------------------------

    def snapshot(self) -> dict:
        """The sampler as plain data. ``row_ticks`` maps every row ever
        assigned to its ticks since its last reset, in ascending row
        order: rows are taken smallest free first, so that is the order
        of their first assignment, as in the JAX sampler's snapshot.
        ``roster_builds``, which the JAX sampler's snapshot lacks,
        counts the roster's builds and stays put on a steady tick."""
        seen = self.fs_row_ticks >= 0
        mesh = None
        if self.fs_mesh is not None:
            mesh = {'axes': list(self.fs_mesh_axes),
                    'shape': dict(self.fs_mesh.shape),
                    'n_devices': self.fs_mesh.size}
        latest = self.fs_latest
        if latest is not None and not isinstance(latest['pools'], dict):
            # Materialize the lazy per-pool view for a JSON surface.
            latest = dict(latest)
            latest['pools'] = dict(latest['pools'])
        control = None
        if self.fs_control:
            last = self.fs_ctrl_last
            control = {
                'enabled': True,
                'last': None if last is None else {
                    'fleet': last['fleet'], 'epoch': last['epoch'],
                    'applied': last['applied'],
                    'rejected': last['rejected'],
                    'skipped': last['skipped'],
                    'step_ms': last['step_ms'],
                },
            }
        health = None
        if self.fs_health:
            mon = self.fs_health_monitor
            health = {
                'enabled': True,
                'monitor': None if mon is None else mon.snapshot(),
            }
        return {
            'interval_ms': self.fs_interval,
            'shard': self.fs_shard,
            'capacity': self.fs_capacity,
            'ticks': self.fs_ticks,
            'rows': dict(self.fs_rows),
            'actuate': self.fs_actuate,
            'control': control,
            'health': health,
            'mesh': mesh,
            'row_ticks': dict(zip(np.flatnonzero(seen).tolist(),
                                  self.fs_row_ticks[seen].tolist())),
            'roster_builds': self.fs_roster_builds,
            'last_tick_visits': self.fs_tick_visits,
            'latest': latest,
        }


def reduce_fleet(records, mesh: Mesh | None = None,
                 mesh_axes=('host', 'chip')) -> dict:
    """Reduce per-shard fleet aggregate rows into one fleet-wide row.

    ``records`` is a list of shard samplers' ``record['fleet']`` dicts.
    ``n_pools`` sums; the mean and fraction fields combine weighted by
    each shard's pool count; ``max_sojourn`` and ``loop_lag_p99_us``
    take the worst shard. Shards with zero pools contribute nothing to
    the weighted fields.

    With a ``mesh``, the per-shard columns split over ``mesh_axes`` and
    reduce over the mesh in float32 (the shard -> host -> mesh tree);
    the columns pad to a multiple of the mesh size with zero-weight
    rows."""
    names = list(_FLEET_GAUGES)
    records = [r for r in records if r]
    if not records:
        return {name: 0.0 for name in names}
    cols = {name: np.asarray([float(r.get(name, 0.0)) for r in records],
                             np.float32)
            for name in names}
    if mesh is None:
        w = cols['n_pools']
        tot = float(w.sum())
        safe = tot if tot > 0.0 else 1.0
        out = {}
        for name in names:
            if name == 'n_pools':
                out[name] = tot
            elif name in ('max_sojourn', 'loop_lag_p99_us'):
                out[name] = float(cols[name].max())
            else:
                out[name] = float((cols[name] * w).sum() / safe)
        return out

    pad = (-len(records)) % mesh.size
    dev = {name: shard_rows(torch.from_numpy(np.pad(col, (0, pad))),
                            mesh, mesh_axes)
           for name, col in cols.items()}
    reducer = Reducer(mesh, mesh_axes)
    w = dev['n_pools']
    tot = reducer.total([x.sum() for x in w])
    safe = torch.where(tot > 0.0, tot, 1.0)
    out = {}
    for name in names:
        if name == 'n_pools':
            out[name] = float(tot)
        elif name in ('max_sojourn', 'loop_lag_p99_us'):
            out[name] = float(reducer.total([x.amax() for x in dev[name]],
                                            'max'))
        else:
            out[name] = float(reducer.total(
                [(x * wx).sum() for x, wx in zip(dev[name], w)]) / safe)
    return out
