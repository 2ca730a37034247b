"""ConnectionPool: claim/release leases over DNS-discovered backends.

Rebuild of reference `lib/pool.js`. A pool maintains busy/init/idle
connection slots per backend, fed by a Resolver's added/removed events:

- spares policy + claim-driven growth to `maximum`
  (reference lib/pool.js:102-124)
- low-pass (128-tap EMA FIR @5Hz) damping of pool shrink under recently
  high load (reference lib/pool.js:37-100,251-262,579-585)
- per-backend churn rate limiting (reference lib/pool.js:599-662)
- decoherence shuffle >=60s (reference lib/pool.js:234-245,501-519;
  rationale docs/internals.adoc:275-386)
- dead-backend declaration + monitor probe slots + failed-state
  short-circuit (reference lib/pool.js:771-794,378-426)
- CoDel claim-queue shedding when targetClaimDelay is set
  (reference lib/pool.js:195-200,735-753,874-885)

Pool FSM: starting -> running <-> failed -> stopping -> stopping.backends
-> stopped (reference lib/pool.js:315-487, docs/api.adoc:180-219).

The claim path is callback-based for parity (`claim_cb`), with an
asyncio-native `claim()` coroutine wrapper returning (handle, connection).
"""

from __future__ import annotations

import asyncio
import logging
import math

from . import codel as mod_codel
from . import errors as mod_errors
from . import trace as mod_trace
from . import utils as mod_utils
from .connection_fsm import (ConnectionSlotFSM, arm_claim_timers,
                             obtain_claim_handle)
from .cqueue import Queue
from .events import EventEmitter
from .fsm import FSM, get_loop
from .runq import defer

# Low-pass filter parameters (reference lib/pool.js:43-48): 5 Hz sampling,
# 128-tap EMA with time constant -0.2 -> pass band ~0.25 Hz, -10 dB at
# 0.5 Hz, -20 dB at 2.5 Hz.
LP_RATE = 5
LP_INT = round(1000 / LP_RATE)

# CoDel pacer cadence lives with the rest of the control-law constants
# (re-exported here for back-compat; see codel.py for the rationale).
CODEL_PACE = mod_codel.CODEL_PACE

# Bound to the profile module while its sampler runs, so SIGPROF
# samples landing inside the CoDel pacer attribute to the codel phase.
_prof = None

# Fleet-actuation advisory freshness bound (ms): ~5 sampler ticks at
# the default 200 ms cadence. Older advisories are ignored and the
# pool's own filter governs again.
FLEET_ADVISORY_TTL = 1000

# How long (ms) after the last accepted control decision a LOWER epoch
# is still treated as stale. A restarted sampler's epoch counter
# restarts from 1; once this window has passed with no decisions, the
# pool trusts the new counter instead of rejecting it forever.
CONTROL_EPOCH_TTL = 5000


def gen_taps(count: int, tc: float) -> list[float]:
    """Generate normalized EMA filter taps (reference lib/pool.js:50-76).
    `tc` is the decay time constant: negative, fractional; closer to 0.0
    means lower cutoff frequency and sharper roll-off."""
    taps = [math.exp(tc * i) for i in range(count)]
    s = sum(taps)
    return [t / s for t in taps]


LP_TAPS = gen_taps(128, -0.2)


class FIRFilter:
    """FIR filter over a circular buffer (reference lib/pool.js:78-100).

    The pure-Python form is the pool's hot-path implementation;
    `cueball_tpu_torch.ops.fir` holds the batched form (the CUDA
    kernel of csrc/fir.cu) used for fleet-wide telemetry. Samples
    arrive at LP_RATE (5 Hz) but the
    output is read on every rebalance pass — potentially thousands of
    times per sample under queued load — so the dot product is
    evaluated lazily once per put() and cached between samples."""

    def __init__(self, taps: list[float]):
        self.f_taps = taps
        self.f_buf = [0.0] * len(taps)
        self.f_ptr = 0
        self.f_out = 0.0
        self.f_dirty = False

    def put(self, v: float) -> None:
        self.f_buf[self.f_ptr] = v
        self.f_ptr += 1
        if self.f_ptr == len(self.f_taps):
            self.f_ptr = 0
        self.f_dirty = True

    def get(self) -> float:
        if not self.f_dirty:
            return self.f_out
        i = self.f_ptr - 1
        if i < 0:
            i += len(self.f_taps)
        acc = 0.0
        for tap in self.f_taps:
            acc += self.f_buf[i] * tap
            i -= 1
            if i < 0:
                i += len(self.f_taps)
        self.f_out = acc
        self.f_dirty = False
        return acc


class _Interval:
    """Recurring timer emitting 'timeout' on an EventEmitter (the node
    setInterval-feeding-an-emitter pattern of reference
    lib/pool.js:228-262). asyncio timers don't hold the loop open, so no
    unref() is needed."""

    def __init__(self, ms: float, emitter: EventEmitter):
        self._ms = ms
        self._emitter = emitter
        self._cancelled = False
        self._handle = None
        self._schedule()

    def _schedule(self):
        loop = get_loop()
        self._handle = loop.call_later(self._ms / 1000.0, self._fire)

    def _fire(self):
        if self._cancelled:
            return
        self._emitter.emit('timeout')
        if not self._cancelled:
            self._schedule()

    def cancel(self):
        self._cancelled = True
        if self._handle is not None:
            self._handle.cancel()


class ConnectionPool(FSM):
    """Reference CueBallConnectionPool (lib/pool.js:125-266 ctor)."""

    def __init__(self, options: dict):
        if not isinstance(options, dict):
            raise AssertionError('options must be a dict')
        constructor = options.get('constructor')
        # The transport seam: options['transport'] (a Transport
        # instance, a registry name, or None) supplies the connection
        # constructor when the caller doesn't pass one explicitly; an
        # explicit constructor always wins (it IS a transport
        # decision the caller already made).
        self.p_transport = None
        if options.get('transport') is not None:
            from . import transport as mod_transport
            self.p_transport = mod_transport.get_transport(
                options['transport'])
            if constructor is None:
                constructor = self.p_transport.connector
        if not callable(constructor):
            raise AssertionError('options.constructor must be callable')

        self.p_uuid = mod_utils.make_uuid()
        self.p_constructor = constructor

        domain = options.get('domain')
        if not isinstance(domain, str):
            raise AssertionError('options.domain must be a string')
        self.p_domain = domain
        mod_utils.assert_claim_delay(options.get('targetClaimDelay'))

        recovery = options.get('recovery')
        mod_utils.assert_recovery_set(recovery or {})
        if not recovery or 'default' not in recovery:
            raise AssertionError('options.recovery.default is required')
        self.p_recovery = recovery

        # Child logger carrying pool identity into every record
        # (reference lib/pool.js:152-157).
        self.p_log = mod_utils.make_child_logger(
            options.get('log') or logging.getLogger('cueball.pool'),
            component='CueBallConnectionPool', domain=domain,
            service=options.get('service'), pool=self.p_uuid)

        self.p_collector = mod_utils.create_error_metrics(options)

        spares = options.get('spares')
        maximum = options.get('maximum')
        if not isinstance(spares, int) or not isinstance(maximum, int):
            raise AssertionError(
                'options.spares and options.maximum must be numbers')
        self.p_spares = spares
        self.p_max = maximum

        self.p_checker = options.get('checker')
        self.p_check_timeout = options.get('checkTimeout')

        self.p_keys: list[str] = []
        self.p_backends: dict[str, dict] = {}
        self.p_connections: dict[str, list[ConnectionSlotFSM]] = {}
        self.p_dead: dict[str, bool] = {}
        self.p_lastrate: dict[str, dict] = {}

        max_churn = options.get('maxChurnRate')
        self.p_maxrate = max_churn if max_churn is not None else math.inf

        self.p_last_rebalance = None
        self.p_in_rebalance = False
        self.p_rebal_scheduled = False
        self.p_started_resolver = False
        self.p_lpf = FIRFilter(LP_TAPS)

        self.p_idleq = Queue()
        self.p_initq = Queue()
        self.p_waiters = Queue()

        self.p_codel = None
        tcd = options.get('targetClaimDelay')
        if isinstance(tcd, (int, float)) and math.isfinite(tcd):
            self.p_codel = mod_codel.ControlledDelay(tcd)
        # Continuous-evaluation pacer state (see codel.CODEL_PACE): armed
        # while a standing queue exists; drops only while a dequeue has
        # happened within the last control interval, so a fully stalled
        # pool keeps the reference's shed-at-dequeue/getMaxIdle-bound
        # behaviour (reference lib/codel.js:96-118).
        self.p_codel_pacer = None
        self.p_last_dequeue = -math.inf
        self.p_pace_shaving = False
        self.p_pace_above_since = 0.0
        self.p_pace_below_since = 0.0
        # Mean-tracking accumulator for the current overload episode
        # (see _pace_comp): sum of (sojourn - target) over every
        # resolved waiter.
        self.p_pace_sum_err = 0.0

        self.p_last_error = None
        self.p_counters: dict[str, int] = {}

        if options.get('resolver') is not None:
            self.p_resolver = options['resolver']
            self.p_resolver_custom = True
        else:
            from .resolver import Resolver
            self.p_resolver = Resolver({
                'resolvers': options.get('resolvers'),
                'domain': domain,
                'service': options.get('service'),
                'maxDNSConcurrency': options.get('maxDNSConcurrency'),
                'defaultPort': options.get('defaultPort'),
                'log': self.p_log,
                'recovery': recovery,
            })
            self.p_resolver_custom = False

        # Periodic rebalance sweep: busy->idle returns are handled lazily
        # (reference lib/pool.js:224-232).
        self.p_rebal_timer = EventEmitter()
        self.p_rebal_timer_inst = _Interval(10000, self.p_rebal_timer)

        # Decoherence shuffle, clamped to >= 60s
        # (reference lib/pool.js:234-245).
        shuffle_intvl = options.get('decoherenceInterval')
        if shuffle_intvl is None or shuffle_intvl < 60:
            shuffle_intvl = 60
        self.p_shuffle_timer = EventEmitter()
        self.p_shuffle_timer_inst = _Interval(
            shuffle_intvl * 1000, self.p_shuffle_timer)

        self.p_last_rebal_clamped = False
        self.p_rate_delay_timer = None

        # Fleet actuation (opt-in, default OFF): when enabled AND a
        # fresh advisory has arrived from a FleetSampler({'actuate':
        # True}), the rebalance shrink clamp consults the batched
        # TPU-computed FIR value instead of the local p_lpf. The laws
        # are identical (tests/test_sampler.py parity), so behavior
        # matches; the flag exists so the default path never depends
        # on a sampler being alive.
        self.p_fleet_actuation = bool(options.get('fleetActuation'))
        self.p_fleet_advisory: tuple[float, float] | None = None

        # Control-plane actuation (opt-in, default OFF): when enabled,
        # a FleetSampler running the fused control step
        # (parallel.control) may push whole decisions — adapted CoDel
        # target + spares plan — through apply_control_decision. Both
        # ends opt in, same contract as fleetActuation: the sampler
        # offers decisions to every row, the pool accepts only under
        # this flag. p_ctrl_epoch/p_ctrl_at implement the stale-epoch
        # guard (see apply_control_decision).
        self.p_control_actuation = bool(options.get('controlActuation'))
        self.p_ctrl_epoch = 0
        self.p_ctrl_at = -math.inf
        # Audit trail of the last accepted decision's health citation
        # (the fleet health verdict the control plane saw when it
        # decided): None until a decision carrying one is accepted.
        self.p_ctrl_health: dict | None = None

        # Fleet-telemetry push handles (see FleetSampler): a tuple so
        # the per-event dirty mark is a plain iteration — empty for the
        # (default) unsampled pool, one entry per attached sampler.
        self.p_telemetry: tuple = ()

        # Low-pass filter sampling at 5 Hz
        # (reference lib/pool.js:249-262).
        self.p_lp_emitter = EventEmitter()
        self.p_lp_emitter.on('timeout', self._lp_sample)
        self.p_lp_timer = _Interval(LP_INT, self.p_lp_emitter)

        super().__init__('starting')

    # -- internals -------------------------------------------------------

    def lp_load_sample(self) -> float:
        """The load figure the 5 Hz LP filter tracks: busy connections
        plus the spares setting (reference lib/pool.js:251-262). Shared
        with the fleet telemetry sampler so the batched law sees exactly
        what the per-pool law sees."""
        conns = sum(len(v) for v in self.p_connections.values())
        spares = len(self.p_idleq) + len(self.p_initq)
        busy = conns - spares
        return busy + self.p_spares

    def _lp_sample(self) -> None:
        self.p_lpf.put(self.lp_load_sample())
        if self.p_last_rebal_clamped:
            self.rebalance()

    def receive_fleet_advisory(self, filtered: float,
                               at_ms: float | None = None) -> None:
        """Store the fleet sampler's batched FIR output for this pool.
        Called every sampler tick when actuation is on; consulted by
        _rebalance only if this pool opted in via fleetActuation."""
        self.p_fleet_advisory = (
            float(filtered),
            at_ms if at_ms is not None else mod_utils.current_millis())

    # -- fleet telemetry push protocol -----------------------------------

    def telemetry_attach(self, handle) -> None:
        """Accept a FleetSampler row handle. From here on the pool
        (and its slots/claims) call handle.mark_dirty() at every event
        that can move a gathered signal, so the sampler re-reads this
        pool only on ticks where something actually changed."""
        self.p_telemetry = self.p_telemetry + (handle,)

    def telemetry_detach(self, handle) -> None:
        self.p_telemetry = tuple(
            h for h in self.p_telemetry if h is not handle)

    def _telemetry_dirty(self) -> None:
        """O(1) per attached sampler: flag this pool's telemetry row
        stale. Cheap enough for the claim hot path (a no-op tuple walk
        when no sampler is attached)."""
        for h in self.p_telemetry:
            h.mark_dirty()

    def set_spares(self, spares: int) -> None:
        """Reconfigure the spares target at runtime (and tell any
        attached fleet sampler the row moved)."""
        if not isinstance(spares, int):
            raise AssertionError('spares must be a number')
        self.p_spares = spares
        self._telemetry_dirty()
        self.rebalance()

    setSpares = set_spares

    def set_maximum(self, maximum: int) -> None:
        """Reconfigure the connection cap at runtime (and tell any
        attached fleet sampler the row moved)."""
        if not isinstance(maximum, int):
            raise AssertionError('maximum must be a number')
        self.p_max = maximum
        self._telemetry_dirty()
        self.rebalance()

    setMaximum = set_maximum

    def apply_control_decision(self, epoch: int, codel_target=None,
                               spares=None, at_ms=None,
                               health=None) -> bool:
        """Guarded control-plane actuation: accept one decision row
        from the fused control step (parallel.control).

        The whole decision is validated BEFORE anything mutates —
        rejection (returns False) leaves the pool, its CoDel state and
        its FSM untouched:

        - the pool must have opted in (``controlActuation`` option);
        - ``epoch`` must be a fresh int: strictly greater than the
          last applied epoch, unless the last apply is older than
          CONTROL_EPOCH_TTL (a restarted sampler's counter restarts;
          after the TTL its decisions are trusted again);
        - ``codel_target`` (when given) needs a live ControlledDelay
          and must sit within [CODEL_TARGET_MIN, CODEL_TARGET_MAX];
        - ``spares`` (when given) must be an int in [0, maximum].

        On accept, only the values that actually moved are applied:
        the CoDel target via the guarded ``set_target`` and the spares
        setting via the same dirty-mark + rebalance path as
        ``set_spares``. ``health`` (when given with an accepted
        decision) is kept verbatim as ``p_ctrl_health`` — the fleet
        health verdict the control plane cited, so a SIGUSR2 dump or
        kang snapshot can answer "what did the controller believe when
        it moved this pool". Cost when the control plane is idle:
        zero — nothing on the claim path reads any of this."""
        if not self.p_control_actuation:
            return False
        now = at_ms if at_ms is not None else mod_utils.current_millis()
        if not isinstance(epoch, int) or isinstance(epoch, bool):
            return False
        stale_ok = now - self.p_ctrl_at > CONTROL_EPOCH_TTL
        if epoch <= self.p_ctrl_epoch and not stale_ok:
            return False
        if codel_target is not None:
            if self.p_codel is None:
                return False
            if not isinstance(codel_target, (int, float)) or \
                    isinstance(codel_target, bool) or \
                    not math.isfinite(codel_target) or \
                    not (mod_codel.CODEL_TARGET_MIN <= codel_target
                         <= mod_codel.CODEL_TARGET_MAX):
                return False
        if spares is not None:
            if not isinstance(spares, int) or isinstance(spares, bool) \
                    or spares < 0 or spares > self.p_max:
                return False
        # Validation complete; apply.
        self.p_ctrl_epoch = epoch
        self.p_ctrl_at = now
        if health is not None:
            self.p_ctrl_health = health
        if codel_target is not None and \
                codel_target != self.p_codel.cd_targdelay:
            self.p_codel.set_target(codel_target)
            self._telemetry_dirty()
        if spares is not None and spares != self.p_spares:
            self.p_spares = spares
            self._telemetry_dirty()
            self.rebalance()
        return True

    applyControlDecision = apply_control_decision

    def _shrink_floor(self) -> float:
        """The low-pass load figure the shrink clamp uses: the fleet
        advisory when actuation is on and the advisory is fresh
        (within FLEET_ADVISORY_TTL), else the local filter. Falling
        back — never blocking — on a stale advisory means a stopped
        or wedged sampler degrades to exactly the stock behavior."""
        if self.p_fleet_actuation and self.p_fleet_advisory is not None:
            val, at = self.p_fleet_advisory
            if mod_utils.current_millis() - at <= FLEET_ADVISORY_TTL:
                return val
        return self.p_lpf.get()

    def _incr_counter(self, counter: str, n: int = 1) -> None:
        mod_utils.update_error_metrics(
            self.p_collector, self.p_uuid, counter)
        self.p_counters[counter] = self.p_counters.get(counter, 0) + n

    _incrCounter = _incr_counter

    def _hwm_counter(self, counter: str, val: int) -> None:
        if self.p_counters.get(counter, -math.inf) < val:
            self.p_counters[counter] = val

    # -- CoDel pacer -----------------------------------------------------
    #
    # Entry mirrors CoDel: shave mode engages only after the queue head
    # has sat above targetClaimDelay continuously for a full control
    # interval (burst tolerance preserved). While engaged, every tick
    # sheds the waiters whose sojourn exceeds the target, pinning head
    # sojourn at ~target instead of letting it ride the release cadence.
    # Exit is hysteretic: mode disengages only after no waiter has
    # crossed the target for a full interval (under sustained overload
    # fresh waiters cross constantly, so it stays engaged). The
    # reference's ControlledDelay at the dequeue sites is untouched; in
    # shave mode it simply stops seeing above-target sojourns and serves
    # instead of dropping.

    def _arm_codel_pacer(self) -> None:
        if self.p_codel is None or self.p_codel_pacer is not None:
            return
        self.p_codel_pacer = get_loop().call_later(
            CODEL_PACE / 1000.0, self._codel_pace)

    def _pace_clocks_reset(self) -> None:
        """Forget the shave-mode clocks so the next overload burst
        gets full CoDel burst tolerance (the analogue of
        ControlledDelay.empty() resetting cd_first_above_time). The
        mean-tracking accumulators survive: transient service stalls
        and hysteresis exits happen mid-episode, and wiping the
        deficit there would re-introduce the ramp-up undershoot."""
        self.p_pace_shaving = False
        self.p_pace_above_since = 0.0
        self.p_pace_below_since = 0.0

    def _pace_reset(self) -> None:
        """Episode over (claim queue fully drained): clocks AND the
        mean-tracking accumulator start fresh."""
        self._pace_clocks_reset()
        self.p_pace_sum_err = 0.0

    def _pace_account(self, sojourn_err: float) -> None:
        """One resolved waiter's (sojourn - target) enters the
        episode's running deficit.

        Clamped to +/- target * (queue_len + 1): the deficit exists to
        repay the CURRENT standing queue's worth of compensation, and
        a genuine overload ramp never banks more than that (arrivals
        outpace service, so the queue grows faster than the deficit).
        Without the clamp, a long healthy-but-never-quite-empty
        stretch (sojourns far below target, queue never draining to
        zero) would bank an unbounded deficit and pin the shed
        threshold at 2x target for minutes into the next real
        overload."""
        self.p_pace_sum_err += sojourn_err
        limit = self.p_codel.cd_targdelay * (len(self.p_waiters) + 1.0)
        if self.p_pace_sum_err < -limit:
            self.p_pace_sum_err = -limit
        elif self.p_pace_sum_err > limit:
            self.p_pace_sum_err = limit

    def _pace_comp(self) -> float:
        """Mean-tracking compensation (ms) added to the shed
        threshold. An overload episode's ramp-up claims structurally
        resolve BELOW target (they can't have waited longer than the
        episode is old), so shedding at exactly `target` leaves the
        episode's average sojourn under the target — ~-240 ms at a
        5000 ms target under the reference's own load protocol
        (test/codel.test.js:245-297). Shedding at
        `target + deficit/queue_len` makes each shed repay an equal
        share of the accumulated deficit; the deficit-per-queued-claim
        ratio is invariant as the queue drains, so the episode's mean
        lands on the target. Capped at `target` (no shed waits past
        2x target; the getMaxIdle bound still applies far above)."""
        if self.p_pace_sum_err >= 0.0 or len(self.p_waiters) == 0:
            return 0.0
        return min(-self.p_pace_sum_err / len(self.p_waiters),
                   self.p_codel.cd_targdelay)

    def _codel_pace(self) -> None:
        prof = _prof
        if prof is None:
            return self._codel_pace_body()
        tok = prof.push_phase('codel')
        try:
            return self._codel_pace_body()
        finally:
            prof.pop_phase(tok)

    def _codel_pace_body(self) -> None:
        self.p_codel_pacer = None
        if self.p_codel is None or \
                self.is_in_state('stopping') or self.is_in_state('stopped'):
            return
        # Resolved handles unlink themselves from p_waiters at their
        # own state entries (CueBallClaimHandle._ch_unpark), so the
        # queue only holds live waiters here (modulo same-tick races
        # handled below).
        if len(self.p_waiters) == 0:
            self._pace_reset()
            return
        now = mod_utils.current_millis()
        if now - self.p_last_dequeue > mod_codel.CODEL_INTERVAL:
            # Service stalled: stop pacing entirely (the reference
            # behaviour — shed at dequeue or at the getMaxIdle bound —
            # takes over). The next dequeue or queued claim re-arms.
            # Clocks only: the episode (standing queue) continues.
            self._pace_clocks_reset()
            return
        target = self.p_codel.cd_targdelay
        interval = mod_codel.CODEL_INTERVAL
        comp = self._pace_comp()
        tracer = mod_trace._runtime
        head_over = False
        while len(self.p_waiters) > 0:
            hdl = self.p_waiters.peek()
            if not hdl.is_in_state('waiting'):
                self.p_waiters.shift()
                continue
            soj = now - hdl.ch_started
            if soj <= target:
                break
            head_over = True
            if self.p_pace_above_since == 0:
                self.p_pace_above_since = now
            if not self.p_pace_shaving and \
                    now - self.p_pace_above_since < interval:
                break
            self.p_pace_shaving = True
            if soj <= target + comp:
                break
            self.p_waiters.shift()
            self._incr_counter('codel-paced-drop')
            if tracer is not None:
                tracer.codel_shed(hdl, 'paced', soj, target)
            self._pace_account(soj - target)
            hdl.timeout()
        if head_over:
            self.p_pace_below_since = 0
        elif self.p_pace_shaving:
            if self.p_pace_below_since == 0:
                self.p_pace_below_since = now
            elif now - self.p_pace_below_since >= interval:
                self._pace_clocks_reset()
        else:
            self.p_pace_above_since = 0
        if len(self.p_waiters) == 0:
            self.p_codel.empty()
            self._pace_reset()
            return
        self._arm_codel_pacer()

    def on_resolver_added(self, k: str, backend: dict) -> None:
        """Insert at a random position in the preference list
        (reference lib/pool.js:285-291; randomized per-client so load
        spreads across the fleet, docs/internals.adoc:275-386)."""
        backend['key'] = k
        idx = mod_utils.get_rng().randrange(len(self.p_keys) + 1)
        self.p_keys.insert(idx, k)
        self.p_backends[k] = backend
        self.rebalance()

    def on_resolver_removed(self, k: str) -> None:
        assert k in self.p_keys, 'resolver key %s not found' % k
        self.p_keys.remove(k)
        self.p_backends.pop(k, None)
        self.p_dead.pop(k, None)
        # Slot cleanup happens in the slot stateChanged handler once the
        # FSMs come to rest (reference lib/pool.js:293-313).
        for fsm in list(self.p_connections.get(k) or []):
            fsm.set_unwanted()

    # -- states ----------------------------------------------------------

    def state_starting(self, S):
        S.validTransitions(['failed', 'running', 'stopping'])
        from .monitor import pool_monitor
        pool_monitor.register_pool(self)

        S.on(self.p_resolver, 'added', self.on_resolver_added)
        S.on(self.p_resolver, 'removed', self.on_resolver_removed)

        if self.p_resolver.is_in_state('failed'):
            self.p_log.warning(
                'pre-provided resolver has already failed, pool will '
                'start up in "failed" state')
            self.p_last_error = mod_errors.CueBallError(
                'Pool resolver entered state "failed"',
                self.p_resolver.get_last_error())
            S.gotoState('failed')
            return

        def on_res_changed(state):
            if state == 'failed':
                self.p_log.warning('underlying resolver failed, moving '
                                   'pool to "failed" state')
                self.p_last_error = mod_errors.CueBallError(
                    'Pool resolver entered state "failed"',
                    self.p_resolver.get_last_error())
                S.gotoState('failed')
        S.on(self.p_resolver, 'stateChanged', on_res_changed)

        if self.p_resolver.is_in_state('running'):
            for k, backend in self.p_resolver.list().items():
                self.on_resolver_added(k, backend)
        elif self.p_resolver.is_in_state('stopped') and \
                not self.p_resolver_custom:
            self.p_resolver.start()
            self.p_started_resolver = True

        S.goto_state_on(self, 'connectedToBackend', 'running')

        def on_closed_backend(*a):
            dead = len(self.p_dead)
            self._hwm_counter('max-dead-backends', dead)
            if dead >= len(self.p_keys):
                self.p_log.warning(
                    'pool has exhausted all retries, now moving to '
                    '"failed" state (%d dead)', dead)
                S.gotoState('failed')
        S.on(self, 'closedBackend', on_closed_backend)

        S.goto_state_on(self, 'stopAsserted', 'stopping')

    def state_failed(self, S):
        S.validTransitions(['running', 'stopping'])
        S.on(self.p_resolver, 'added', self.on_resolver_added)
        S.on(self.p_resolver, 'removed', self.on_resolver_removed)
        S.on(self.p_shuffle_timer, 'timeout', self.reshuffle)

        def on_connected(*a):
            assert not self.p_resolver.is_in_state('failed')
            self.p_log.info('successfully connected to a backend, '
                            'moving back to running state')
            S.gotoState('running')
        S.on(self, 'connectedToBackend', on_connected)

        S.goto_state_on(self, 'stopAsserted', 'stopping')

        self._incr_counter('failed-state')

        # Pending-event re-check: a sibling slot may have connected in
        # this very loop turn — its 'connectedToBackend' fired while
        # 'running' (which has no listener for it) just before the
        # last-dead-backend event pushed us here. The reference only
        # listens for FUTURE connects and can wedge in 'failed' on this
        # interleaving; re-checking current slot state on entry designs
        # the race out (same pattern as the slot busy-state check,
        # reference lib/connection-fsm.js:881-889).
        for conns in self.p_connections.values():
            for fsm in conns:
                if fsm.is_in_state('idle') or fsm.is_in_state('busy'):
                    self.p_log.info(
                        'entered failed with a live connection already '
                        'up; returning to running')
                    S.gotoState('running')
                    return

        # Fail all outstanding waiting claims
        # (reference lib/pool.js:398-406).
        while not self.p_waiters.is_empty():
            hdl = self.p_waiters.shift()
            if hdl.is_in_state('waiting'):
                hdl.fail(mod_errors.PoolFailedError(
                    self, self.p_last_error))

    def state_running(self, S):
        S.validTransitions(['failed', 'stopping'])
        S.on(self.p_resolver, 'added', self.on_resolver_added)
        S.on(self.p_resolver, 'removed', self.on_resolver_removed)
        S.on(self.p_rebal_timer, 'timeout', self.rebalance)
        S.on(self.p_shuffle_timer, 'timeout', self.reshuffle)

        def on_closed_backend(*a):
            dead = len(self.p_dead)
            self._hwm_counter('max-dead-backends', dead)
            if dead >= len(self.p_keys):
                self.p_log.warning(
                    'pool has exhausted all retries, now moving to '
                    '"failed" state (%d dead)', dead)
                S.gotoState('failed')
        S.on(self, 'closedBackend', on_closed_backend)

        S.goto_state_on(self, 'stopAsserted', 'stopping')

    def state_stopping(self, S):
        S.validTransitions(['stopping.backends'])
        if self.p_started_resolver:
            def on_res_changed(s):
                if s == 'stopped':
                    S.gotoState('stopping.backends')
            S.on(self.p_resolver, 'stateChanged', on_res_changed)
            self.p_resolver.stop()
            if self.p_resolver.is_in_state('stopped'):
                S.gotoState('stopping.backends')
        else:
            S.gotoState('stopping.backends')

    def state_stopping_backends(self, S):
        S.validTransitions(['stopped'])
        fsms = [fsm for conns in self.p_connections.values()
                for fsm in conns]
        remaining = {'n': len(fsms)}

        def done_one():
            remaining['n'] -= 1
            if remaining['n'] == 0:
                S.gotoState('stopped')

        if not fsms:
            S.immediate(lambda: S.gotoState('stopped'))
            return

        for fsm in fsms:
            fsm.set_unwanted()
            if fsm.is_in_state('stopped') or fsm.is_in_state('failed'):
                done_one()
            else:
                def on_changed(st, _fsm=fsm):
                    if st in ('stopped', 'failed'):
                        done_one()
                S.on(fsm, 'stateChanged', on_changed)

    def state_stopped(self, S):
        S.validTransitions([])
        from .monitor import pool_monitor
        pool_monitor.unregister_pool(self)
        self.p_keys = []
        self.p_connections = {}
        self.p_backends = {}
        self.p_rebal_timer_inst.cancel()
        self.p_shuffle_timer_inst.cancel()
        self.p_lp_timer.cancel()
        if self.p_rate_delay_timer is not None:
            self.p_rate_delay_timer.cancel()
        if self.p_codel_pacer is not None:
            self.p_codel_pacer.cancel()
            self.p_codel_pacer = None

    # -- public helpers --------------------------------------------------

    def should_retry_backend(self, backend: str) -> bool:
        return backend in self.p_backends

    def is_declared_dead(self, backend: str) -> bool:
        return self.p_dead.get(backend) is True

    isDeclaredDead = is_declared_dead

    def get_last_error(self):
        return self.p_last_error

    getLastError = get_last_error

    def reshuffle(self) -> None:
        """Decoherence shuffle: move a random preference entry so
        per-client orderings decorrelate over time
        (reference lib/pool.js:501-519)."""
        if len(self.p_keys) <= 1:
            return
        taken = self.p_keys.pop()
        idx = mod_utils.get_rng().randrange(len(self.p_keys) + 1)
        conns = sum(len(v) for v in self.p_connections.values())
        if len(self.p_keys) > conns and idx < conns:
            self.p_log.info('random shuffle puts backend "%s" at idx %d',
                            taken, idx)
        self.p_keys.insert(idx, taken)
        self.rebalance()

    def stop(self) -> None:
        self.emit('stopAsserted')

    # -- rebalancing -----------------------------------------------------

    def rebalance(self, *_a) -> None:
        if len(self.p_keys) < 1:
            return
        if self.is_in_state('stopping') or self.is_in_state('stopped'):
            return
        if self.p_rebal_scheduled is not False:
            return
        self.p_rebal_scheduled = True
        defer(self._rebalance)

    def _rebalance(self) -> None:
        """Compute and apply a plan toward even distribution
        (reference lib/pool.js:544-666)."""
        if self.p_in_rebalance is not False:
            return
        self.p_in_rebalance = True
        self.p_rebal_scheduled = False

        total = 0
        conns: dict[str, list] = {}
        for k in self.p_keys:
            conns[k] = list(self.p_connections.get(k) or [])
            total += len(conns[k])
        spares = len(self.p_idleq) + len(self.p_initq) - \
            len(self.p_waiters)
        if spares < 0:
            spares = 0
        busy = total - spares
        if busy < 0:
            busy = 0
        extras = len(self.p_waiters) - len(self.p_initq)
        if extras < 0:
            extras = 0

        target = busy + extras + self.p_spares

        # Clamp shrinking against the low-pass-filtered recent load
        # (reference lib/pool.js:577-592); the figure comes from the
        # fleet advisory when actuation is enabled (_shrink_floor).
        min_ = math.ceil(self._shrink_floor())
        if target < min_ * 1.05:
            target = min_
            self.p_last_rebal_clamped = True
        else:
            self.p_last_rebal_clamped = False

        if target > self.p_max:
            target = self.p_max

        plan = mod_utils.plan_rebalance(
            conns, self.p_dead, target, self.p_max)

        if plan['remove'] or plan['add']:
            self.p_log.debug(
                'rebalancing pool, remove %d, add %d (busy = %d, '
                'spares = %d, target = %d)', len(plan['remove']),
                len(plan['add']), busy, spares, target)

        now = mod_utils.wall_time()
        rate_delay = None

        for fsm in plan['remove']:
            k = fsm.get_backend()['key']
            lastrate = self.p_lastrate.get(k)
            n = len(self.p_connections.get(k) or []) - 1
            if lastrate:
                tdelta = now - lastrate['time']
                ndelta = n - lastrate['count']
                rate = abs(ndelta / tdelta) if tdelta else math.inf
                if rate > self.p_maxrate:
                    tnext = lastrate['time'] + \
                        abs(ndelta) / self.p_maxrate
                    delay = tnext - now
                    if rate_delay is None or delay < rate_delay:
                        rate_delay = delay
                    continue
            self.p_lastrate[k] = {'time': now, 'count': n}

            fsm.set_unwanted()
            # If it stopped synchronously, don't count it against the cap
            # (reference lib/pool.js:646-653).
            if fsm.is_in_state('stopped') or fsm.is_in_state('failed'):
                total -= 1

        for k in plan['add']:
            lastrate = self.p_lastrate.get(k)
            n = len(self.p_connections.get(k) or []) + 1
            if lastrate:
                tdelta = now - lastrate['time']
                ndelta = n - lastrate['count']
                rate = abs(ndelta / tdelta) if tdelta else math.inf
                if rate > self.p_maxrate:
                    tnext = lastrate['time'] + \
                        abs(ndelta) / self.p_maxrate
                    delay = tnext - now
                    if rate_delay is None or delay < rate_delay:
                        rate_delay = delay
                    continue
            self.p_lastrate[k] = {'time': now, 'count': n}
            total += 1
            if total > self.p_max:
                # Never exceed the socket cap.
                continue
            self.add_connection(k)

        if rate_delay is not None:
            if self.p_rate_delay_timer is not None:
                self.p_rate_delay_timer.cancel()
            self.p_rate_delay_timer = get_loop().call_later(
                (rate_delay * 1000 + 10) / 1000.0, self.rebalance)

        self.p_in_rebalance = False
        self.p_last_rebalance = mod_utils.wall_time()

    def add_connection(self, key: str) -> None:
        """Create a slot for `key` and wire the pool's slot stateChanged
        orchestration (reference lib/pool.js:668-810)."""
        if self.is_in_state('stopping') or self.is_in_state('stopped'):
            return

        backend = self.p_backends[key]
        backend['key'] = key

        fsm = ConnectionSlotFSM({
            'constructor': self.p_constructor,
            'backend': backend,
            'log': self.p_log,
            'pool': self,
            'checker': self.p_checker,
            'checkTimeout': self.p_check_timeout,
            'recovery': self.p_recovery,
            'monitor': self.p_dead.get(key) is True,
        })
        self.p_connections.setdefault(key, []).append(fsm)

        fsm.p_initq_node = self.p_initq.push(fsm)
        fsm.p_idleq_node = None

        def on_changed(new_state):
            # Every slot transition can move the busy count (and so
            # the gathered load sample); one dirty mark covers all the
            # branches below.
            self._telemetry_dirty()
            if fsm.p_initq_node:
                # Still starting up during these transitions.
                if new_state in ('init', 'connecting', 'retrying'):
                    return
                fsm.p_initq_node.remove()
                fsm.p_initq_node = None

            if new_state == 'idle':
                self.emit('connectedToBackend', key, fsm)
                if key in self.p_dead:
                    del self.p_dead[key]
                    self.rebalance()

            if new_state == 'idle' and fsm.is_in_state('idle'):
                # Slot became available: hand to a waiter or queue idle.
                if key not in self.p_backends:
                    fsm.set_unwanted()
                    return

                self.p_last_dequeue = mod_utils.current_millis()
                # Both shed sites share the pacer's mean-tracking
                # threshold: the start is shifted forward by the
                # compensation so the scalar CoDel only sees a claim
                # as over-target once its TRUE sojourn exceeds
                # target + comp (see _pace_comp).
                comp = self._pace_comp() if self.p_codel is not None \
                    else 0.0
                while len(self.p_waiters) > 0:
                    hdl = self.p_waiters.shift()
                    drop = self.p_codel is not None and \
                        self.p_codel.overloaded(hdl.ch_started + comp)
                    if not hdl.is_in_state('waiting'):
                        continue
                    if self.p_codel is not None:
                        # Every resolved waiter (served or dropped)
                        # feeds the pacer's mean-tracking deficit.
                        self._pace_account(
                            self.p_last_dequeue - hdl.ch_started -
                            self.p_codel.cd_targdelay)
                    if drop:
                        tracer = mod_trace._runtime
                        if tracer is not None:
                            tracer.codel_shed(
                                hdl, 'dequeue',
                                self.p_last_dequeue - hdl.ch_started,
                                self.p_codel.cd_targdelay)
                        hdl.timeout()
                        continue
                    if self.p_codel is not None:
                        # Service is live again; waiters may remain
                        # queued behind this one, so resume pacing.
                        self._arm_codel_pacer()
                    if hdl.ch_trace is not None:
                        if self.p_codel is not None:
                            hdl.ch_trace.codel_decision(
                                'served',
                                self.p_last_dequeue - hdl.ch_started,
                                self.p_codel.cd_targdelay)
                        hdl.ch_trace.slot_selected('drain')
                    hdl.try_(fsm)
                    return

                if self.p_codel is not None:
                    self.p_codel.empty()
                    self._pace_reset()

                fsm.p_idleq_node = self.p_idleq.push(fsm)
                return

            # Health-check claims sit on the initq so they don't count
            # as busy (reference lib/pool.js:762-768).
            if new_state == 'busy' and fsm.is_running_ping() and \
                    not fsm.p_initq_node:
                fsm.p_initq_node = self.p_initq.push(fsm)

            if new_state == 'failed':
                # No dead mark if the backend has been removed
                # (regression #144, reference lib/pool.js:771-777), or
                # if a sibling slot is connected to it right now — the
                # backend demonstrably works, and whether its 'idle'
                # lands before or after our 'failed' must not decide
                # the pool's fate (the reference relies on the
                # idle-clears-dead ordering here).
                sibling_up = any(
                    s is not fsm and (s.is_in_state('idle') or
                                      s.is_in_state('busy'))
                    for s in self.p_connections.get(key, ()))
                if key in self.p_backends and not sibling_up:
                    self.p_dead[key] = True
                err = fsm.get_socket_mgr().get_last_error()
                if err is not None:
                    self.p_last_error = err

            if new_state in ('stopped', 'failed'):
                lst = self.p_connections.get(key)
                if lst:
                    assert fsm in lst
                    lst.remove(fsm)
                    if not lst:
                        del self.p_connections[key]
                self.emit('closedBackend', key, fsm)
                self.rebalance()

            if fsm.p_idleq_node:
                # Was idle, now isn't: off the idle queue.
                fsm.p_idleq_node.remove()
                fsm.p_idleq_node = None
                self.rebalance()

        fsm.on('stateChanged', on_changed)
        fsm.start()
        # The initq push above changed the load sample immediately;
        # the slot's first stateChanged only lands next loop turn.
        self._telemetry_dirty()

    addConnection = add_connection

    def print_connections(self) -> dict:
        """Debug dump of per-backend slot states
        (reference lib/pool.js:812-832); returns the structure it
        prints."""
        obj: dict = {'connections': {}, 'dead': dict(self.p_dead)}
        ks = list(self.p_keys)
        for k in self.p_connections.keys():
            if k not in ks:
                ks.append(k)
        for k in ks:
            counts: dict[str, int] = {}
            for fsm in self.p_connections.get(k) or []:
                s = fsm.get_state()
                counts[s] = counts.get(s, 0) + 1
            obj['connections'][k] = counts
        print('live:', obj['connections'])
        print('dead:', obj['dead'])
        return obj

    printConnections = print_connections

    # -- stats -----------------------------------------------------------

    def get_stats(self) -> dict:
        """Counter snapshot + queue gauges (reference lib/pool.js:834-857,
        added for #132)."""
        tconns = sum(len(v) for v in self.p_connections.values())
        return {
            'counters': dict(self.p_counters),
            'totalConnections': tconns,
            'idleConnections': len(self.p_idleq),
            'pendingConnections': len(self.p_initq),
            'waiterCount': len(self.p_waiters),
        }

    getStats = get_stats

    def codel_enabled(self) -> bool:
        """Whether this pool derives claim deadlines from CoDel
        (targetClaimDelay). Such pools reject an explicit claim
        timeout (reference lib/pool.js:874-885); integration layers
        use this to decide whether to forward one."""
        return self.p_codel is not None

    # -- claim -----------------------------------------------------------

    def claim_cb(self, options=None, cb=None):
        """Callback-style claim (reference lib/pool.js:859-969). Returns
        the ClaimHandle (or a cancel-shim for early failures). ``cb`` is
        called with (err) or (None, handle, connection)."""
        if callable(options) and cb is None:
            cb = options
            options = {}
        options = options or {}
        if not callable(cb):
            raise AssertionError('cb must be callable')
        err_on_empty = options.get('errorOnEmpty')

        if self.p_codel is not None:
            if isinstance(options.get('timeout'), (int, float)):
                raise RuntimeError('options.timeout not allowed when '
                                   'targetClaimDelay has been set')
            timeout = self.p_codel.get_max_idle()
        elif isinstance(options.get('timeout'), (int, float)):
            timeout = options['timeout']
        else:
            timeout = math.inf

        self._incr_counter('claim')

        state = {'done': False}
        if self.is_in_state('stopping') or self.is_in_state('stopped'):
            def fail_stopping():
                if not state['done']:
                    cb(mod_errors.PoolStoppingError(self))
                state['done'] = True
            defer(fail_stopping)
            return _CancelShim(state)
        if self.is_in_state('failed'):
            def fail_failed():
                if not state['done']:
                    cb(mod_errors.PoolFailedError(
                        self, self.p_last_error))
                state['done'] = True
            defer(fail_failed)
            return _CancelShim(state)

        e = mod_utils.maybe_capture_stack_trace()

        handle = obtain_claim_handle({
            'pool': self,
            'claimStack': e['stack'],
            'callback': cb,
            'log': self.p_log,
            'claimTimeout': timeout,
        })

        # Tracing off: one module-global load + None check per claim.
        tracer = mod_trace._runtime
        if tracer is not None:
            tracer.claim_begin(handle, self)

        def try_next():
            if not handle.is_in_state('waiting'):
                return

            # Take an idle connection if one is truly idle. Entries may
            # be stale (stateChanged is emitted async); rip them off and
            # move on (reference lib/pool.js:929-951).
            while len(self.p_idleq) > 0:
                fsm = self.p_idleq.shift()
                fsm.p_idleq_node = None
                if not fsm.is_in_state('idle'):
                    continue
                # The idleq shift moved the busy count NOW; the slot's
                # 'busy' stateChanged only lands next loop turn.
                self._telemetry_dirty()
                if handle.ch_trace is not None:
                    handle.ch_trace.slot_selected('idleq')
                handle.try_(fsm)
                return

            if err_on_empty and self.p_resolver.count() < 1:
                handle.fail(mod_errors.NoBackendsError(
                    self, self.p_resolver.get_last_error()))
                return

            handle.ch_waiter_node = self.p_waiters.push(handle)
            self._telemetry_dirty()   # a head sojourn may now exist
            handle.arm_claim_timer()
            self._hwm_counter('max-claim-queue', len(self.p_waiters))
            self._incr_counter('queued-claim')
            self._arm_codel_pacer()
            self.rebalance()

        # First try runs next tick (the reference's deferred
        # stateChanged('waiting') ordering); re-entries to 'waiting'
        # (claim rejected) re-schedule via ch_requeue, and queue-node
        # unlink on resolution lives in the handle's own state entries
        # (_ch_unpark) — no per-claim stateChanged subscription.
        handle.ch_requeue = try_next
        defer(try_next)

        return handle

    async def claim(self, options: dict | None = None):
        """Asyncio-native claim: returns (handle, connection); raises the
        claim error otherwise. Cancelling the awaiting task cancels the
        claim (so the callback contract of the reference's
        waiter.cancel() maps onto task cancellation)."""
        loop = get_loop()
        fut: asyncio.Future = loop.create_future()

        def cb(err, hdl=None, conn=None):
            if fut.cancelled():
                if hdl is not None:
                    hdl.release()
                return
            if err is not None:
                fut.set_exception(err)
            else:
                fut.set_result((hdl, conn))

        waiter = self.claim_cb(options, cb)
        try:
            return await fut
        except asyncio.CancelledError:
            waiter.cancel()
            raise

    # -- batched claim ---------------------------------------------------

    def _claim_retry(self, handle, err_on_empty) -> None:
        """Single-handle requeue for claim_many handles (the exact
        try_next body of claim_cb): runs when a rejected handshake
        re-enters 'waiting'. Re-entries are rare, so the park
        bookkeeping here is per-handle, not batched."""
        if not handle.is_in_state('waiting'):
            return
        while len(self.p_idleq) > 0:
            fsm = self.p_idleq.shift()
            fsm.p_idleq_node = None
            if not fsm.is_in_state('idle'):
                continue
            self._telemetry_dirty()
            if handle.ch_trace is not None:
                handle.ch_trace.slot_selected('idleq')
            handle.try_(fsm)
            return
        if err_on_empty and self.p_resolver.count() < 1:
            handle.fail(mod_errors.NoBackendsError(
                self, self.p_resolver.get_last_error()))
            return
        handle.ch_waiter_node = self.p_waiters.push(handle)
        self._telemetry_dirty()
        handle.arm_claim_timer()
        self._hwm_counter('max-claim-queue', len(self.p_waiters))
        self._incr_counter('queued-claim')
        self._arm_codel_pacer()
        self.rebalance()

    def claim_many_cb(self, n: int, options=None, cb=None):
        """Batched callback claim: mint ``n`` claims with the
        per-claim bookkeeping paid once per batch — one option/timeout
        parse, one pool-state check, one stack capture, one deferred
        dispatch hop, and (for the parked remainder) one telemetry
        flag, one queued-claim counter bump, one pacer nudge, one
        rebalance and one timer-wheel bucket resolution. ``cb`` fires
        once per claim with the single-claim (err) / (None, handle,
        connection) signature; claims that find no idle slot park in
        the wait queue exactly like single claims (FIFO order
        preserved within the batch). Returns the list of ClaimHandles
        (or cancel-shims when the pool is stopping/failed)."""
        if callable(options) and cb is None:
            cb = options
            options = {}
        options = options or {}
        if not callable(cb):
            raise AssertionError('cb must be callable')
        if not isinstance(n, int) or n < 0:
            raise AssertionError('n must be a non-negative integer')
        err_on_empty = options.get('errorOnEmpty')

        if self.p_codel is not None:
            if isinstance(options.get('timeout'), (int, float)):
                raise RuntimeError('options.timeout not allowed when '
                                   'targetClaimDelay has been set')
            timeout = self.p_codel.get_max_idle()
        elif isinstance(options.get('timeout'), (int, float)):
            timeout = options['timeout']
        else:
            timeout = math.inf

        self._incr_counter('claim', n)

        if self.is_in_state('stopping') or self.is_in_state('stopped') \
                or self.is_in_state('failed'):
            failed = self.is_in_state('failed')
            states = [{'done': False} for _ in range(n)]

            def fail_all():
                for st in states:
                    if not st['done']:
                        cb(mod_errors.PoolFailedError(
                            self, self.p_last_error) if failed
                           else mod_errors.PoolStoppingError(self))
                    st['done'] = True
            defer(fail_all)
            return [_CancelShim(st) for st in states]

        e = mod_utils.maybe_capture_stack_trace()
        tracer = mod_trace._runtime
        handles = []
        for _ in range(n):
            handle = obtain_claim_handle({
                'pool': self,
                'claimStack': e['stack'],
                'callback': cb,
                'log': self.p_log,
                'claimTimeout': timeout,
            })
            if tracer is not None:
                tracer.claim_begin(handle, self)
            # Rejection re-entries keep single-claim semantics via the
            # per-handle retry; only the initial dispatch is batched.
            handle.ch_requeue = \
                lambda h=handle: self._claim_retry(h, err_on_empty)
            handles.append(handle)

        def dispatch():
            parked = []
            touched_idle = False
            for handle in handles:
                if not handle.is_in_state('waiting'):
                    continue
                slot = None
                # Stale idleq entries: same rip-and-move-on as
                # claim_cb's try_next (reference lib/pool.js:929-951).
                while len(self.p_idleq) > 0:
                    fsm = self.p_idleq.shift()
                    fsm.p_idleq_node = None
                    if fsm.is_in_state('idle'):
                        slot = fsm
                        break
                if slot is not None:
                    touched_idle = True
                    if handle.ch_trace is not None:
                        handle.ch_trace.slot_selected('idleq')
                    handle.try_(slot)
                    continue
                if err_on_empty and self.p_resolver.count() < 1:
                    handle.fail(mod_errors.NoBackendsError(
                        self, self.p_resolver.get_last_error()))
                    continue
                parked.append(handle)
            if touched_idle:
                # Idleq shifts moved the busy count NOW; one flag
                # covers the whole batch.
                self._telemetry_dirty()
            if parked:
                for handle in parked:
                    handle.ch_waiter_node = self.p_waiters.push(handle)
                arm_claim_timers(parked)
                self._telemetry_dirty()
                self._hwm_counter('max-claim-queue',
                                  len(self.p_waiters))
                self._incr_counter('queued-claim', len(parked))
                self._arm_codel_pacer()
                self.rebalance()

        defer(dispatch)
        return handles

    async def claim_many(self, n: int, options: dict | None = None):
        """Asyncio-native batched claim: returns a list of ``n``
        (handle, connection) pairs once every claim in the batch has
        resolved. If any claim fails, the batch's successful claims
        are released and the first error raised (all-or-nothing, so a
        partial batch can't leak leases). Cancelling the awaiting
        task cancels unresolved claims and releases resolved ones."""
        if n == 0:
            return []
        loop = get_loop()
        fut: asyncio.Future = loop.create_future()
        results: list = []
        state = {'pending': n, 'err': None}

        def cb(err, hdl=None, conn=None):
            if fut.cancelled():
                if hdl is not None:
                    hdl.release()
                return
            if err is not None:
                if state['err'] is None:
                    state['err'] = err
            else:
                results.append((hdl, conn))
            state['pending'] -= 1
            if state['pending'] == 0:
                if state['err'] is not None:
                    for pair in results:
                        pair[0].release()
                    fut.set_exception(state['err'])
                else:
                    fut.set_result(results)

        waiters = self.claim_many_cb(n, options, cb)
        try:
            return await fut
        except asyncio.CancelledError:
            for w in waiters:
                w.cancel()
            raise

    def release_many(self, handles) -> None:
        """Release a batch of claimed handles. Each release's slot
        events defer through the runq pump, so the whole batch drains
        in one pump tick instead of one loop turn apiece."""
        for h in handles:
            h.release()


class _CancelShim:
    """Stands in for a handle when claim() fails fast
    (reference lib/pool.js:889-910)."""

    def __init__(self, state):
        self._state = state

    def cancel(self):
        self._state['done'] = True
