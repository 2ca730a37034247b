"""The slot stack: SocketMgrFSM, CueBallClaimHandle, ConnectionSlotFSM.

Rebuild of reference `lib/connection-fsm.js`. Three interlocking Moore
machines manage each pool/set "slot":

- :class:`SocketMgrFSM` wraps one live "connection" at a time (constructed
  via the user-supplied ``constructor(backend)``), deduplicates
  connect/error/close/timeout events, and implements exponential backoff
  with randomized spread and a "monitor" mode (infinite retries pinned at
  max backoff) used to probe dead backends
  (reference lib/connection-fsm.js:68-425).
- :class:`CueBallClaimHandle` is the FSM handed to users on claim():
  waiting→claiming→claimed→released/closed (+cancelled/failed), running
  the double-handshake with the slot (try→claim→accept/reject) that
  closes the claim-vs-disconnect race, claim timeouts, and leaked-
  event-handler detection on release
  (reference lib/connection-fsm.js:427-808, docs/internals.adoc:454-477).
- :class:`ConnectionSlotFSM` drives the SocketMgr (when to retry vs.
  reconnect vs. stop), honors the pool's ``wanted`` flag, accepts claims,
  converts a monitor slot into a normal slot on success, and schedules
  idle-time health checks (reference lib/connection-fsm.js:810-1242).

Connection interface expected from ``constructor(backend)`` (reference
docs/api.adoc:580-645): an EventEmitter emitting ``connect``, ``error``,
``close`` (and optionally ``connectError``, ``timeout``,
``connectTimeout``) with a ``destroy()`` method; optionally
``ref()/unref()``, ``setUnwanted()``, and a ``localPort`` attribute.
"""

from __future__ import annotations

import logging
import math

from . import errors as mod_errors
from . import runq as mod_runq
from . import trace as mod_trace
from . import utils as mod_utils
from . import wiretap as mod_wiretap
from .events import _native
from .fsm import FSM
from .runq import defer

# Bound to the profile module while its sampler runs, so SIGPROF
# samples landing inside connection-open plumbing attribute to the
# socket_wait phase.
_prof = None

# Terminal claim handles are recycled through a C freelist when the
# native engine is loaded (see obtain_claim_handle): allocating the
# handle + its dict + FSM innards is a measurable slice of the queued
# claim path (docs/claim-path-profile.md round 6).
_HANDLE_FREELIST = _native is not None and \
    hasattr(_native, 'handle_free_pop')

# FSM state-handle gates are framework-internal listeners; the native
# Gate type carries no attributes, so recognize it by type.
_GATE_TYPE = _native.Gate if _native is not None else None


def _assert_obj(v, name):
    if not isinstance(v, dict) and v is None:
        raise AssertionError('%s is required' % name)


def count_listeners(emitter, event: str) -> int:
    """Count user-attached listeners, ignoring the framework's own
    (reference lib/connection-fsm.js:786-808 filters by function name; we
    mark internal handlers with a `_cueball_internal` attribute)."""
    try:
        # Native emitters filter in C over a snapshot of the list.
        return emitter.count_external(event)
    except AttributeError:
        pass
    try:
        ls = emitter._ee_listeners.get(event, ())
    except AttributeError:
        ls = emitter.listeners(event)
    n = 0
    for h in ls:
        if not callable(h) or getattr(h, '_cueball_internal', False):
            continue
        if _GATE_TYPE is not None and type(h) is _GATE_TYPE:
            continue
        w = getattr(h, '__wrapped_listener__', None)
        if w is not None:
            if getattr(w, '_cueball_internal', False):
                continue
            if _GATE_TYPE is not None and type(w) is _GATE_TYPE:
                continue
        n += 1
    return n


def _internal(fn):
    fn._cueball_internal = True
    return fn


# Events swept by the release leak check (reference
# lib/connection-fsm.js:786-808 sweeps the same four).
_LEAK_EVENTS = ('close', 'error', 'readable', 'data')


def _listener_epoch(emitter):
    """External-listener mutation epoch of `emitter`, or None when the
    emitter doesn't expose one (foreign emitter: always sweep).

    Both engine emitters bump a counter on every *external* listener
    add/remove (framework gates don't count), so an unchanged epoch
    proves the leak-check counts cannot have moved and the per-event
    ``count_listeners`` sweep can be skipped on the claim hot path."""
    mc = getattr(emitter, 'mutation_count', None)
    if mc is None:
        return None
    try:
        return mc()
    except TypeError:
        return None


_STACK_PARSE_CACHE: dict[int, tuple[str, list]] = {}


def _parse_stack(stack: str) -> list:
    """Parse a formatted stack into stripped frame lines. Stack capture
    is off by default (reference lib/utils.js:52-58), so every claim
    passes the same placeholder string — cache its parse by identity."""
    cached = _STACK_PARSE_CACHE.get(id(stack))
    if cached is not None and cached[0] is stack:
        return list(cached[1])
    parsed = [l.strip().removeprefix('at ')
              for l in stack.split('\n')[1:]]
    if len(_STACK_PARSE_CACHE) < 8:
        _STACK_PARSE_CACHE[id(stack)] = (stack, parsed)
    return list(parsed)


# ---------------------------------------------------------------------------
# SocketMgrFSM

class SocketMgrFSM(FSM):
    """Owns one connection at a time; states init/connecting/connected/
    error/backoff/closed/failed (reference lib/connection-fsm.js:85-425).

    Driven by its ConnectionSlotFSM through the signal functions
    ``connect()``, ``retry()``, ``close()``.
    """

    def __init__(self, options: dict):
        constructor = options['constructor']
        if not callable(constructor):
            raise AssertionError('options.constructor must be callable')
        self.sm_pool = options['pool']
        self.sm_backend = options['backend']
        # Small-int backend identity for the attribution surfaces: the
        # native trace recorder stamps it into slot flags so drained
        # claims land in the right per-backend health column even when
        # the Python-side span payload is gone (trace.backend_index).
        self.sm_backend_index = mod_trace.backend_index(
            self.sm_backend.get('key'))
        self.sm_constructor = constructor
        self.sm_slot = options['slot']

        recovery = options['recovery']
        connect_recov = recovery.get('default')
        initial_recov = recovery.get('default')
        if recovery.get('connect'):
            initial_recov = recovery['connect']
            connect_recov = recovery['connect']
        if recovery.get('initial'):
            initial_recov = recovery['initial']
        mod_utils.assert_recovery(connect_recov, 'recovery.connect')
        mod_utils.assert_recovery(initial_recov, 'recovery.initial')
        self.sm_initial_recov = initial_recov
        self.sm_connect_recov = connect_recov

        # Backend identity rides on every record
        # (reference lib/connection-fsm.js:149-155); a localPort child
        # is layered on at connect time (state_connected).
        self.sm_log = mod_utils.make_child_logger(
            options.get('log') or logging.getLogger('cueball.socketmgr'),
            component='CueBallSocketMgrFSM',
            backend=self.sm_backend.get('key'),
            address=self.sm_backend.get('address'),
            port=self.sm_backend.get('port'))

        self.sm_last_error = None
        self.sm_socket = None
        self.sm_monitor: bool | None = None
        # Last completed connect as (start_ms, end_ms): claim traces
        # attach it as their 'connect' child span, whether the connect
        # happened during the claim or predates it (trace.py).
        self.sm_connect_started = None
        self.sm_last_connect = None

        super().__init__('init')
        self.set_monitor(bool(options['monitor']))

    # -- knobs -----------------------------------------------------------

    def set_monitor(self, value: bool) -> None:
        """Toggle monitor mode: infinite retries, no exponential growth —
        timeout/delay pinned at their max values
        (reference lib/connection-fsm.js:171-184)."""
        assert self.is_in_state('init') or self.is_in_state('connected')
        if value == self.sm_monitor:
            return
        self.sm_monitor = value
        self.reset_backoff()

    setMonitor = set_monitor

    def reset_backoff(self) -> None:
        r = self.sm_initial_recov
        self.sm_retries = r['retries']
        self.sm_retries_left = r['retries']
        self.sm_min_delay = r['delay']
        self.sm_delay = r['delay']
        self.sm_max_delay = r.get('maxDelay') or math.inf
        self.sm_timeout = r['timeout']
        self.sm_max_timeout = r.get('maxTimeout') or math.inf
        self.sm_delay_spread = r.get('delaySpread') or 0.2

        if self.sm_monitor is True:
            mult = 1 << int(self.sm_retries)
            self.sm_delay = self.sm_max_delay
            if not math.isfinite(self.sm_delay):
                self.sm_delay = r['delay'] * mult
            self.sm_timeout = self.sm_max_timeout
            if not math.isfinite(self.sm_timeout):
                self.sm_timeout = r['timeout'] * mult
            # Keep retrying a failed backend forever.
            self.sm_retries = math.inf
            self.sm_retries_left = math.inf

    resetBackoff = reset_backoff

    def _sm_telemetry_dirty(self) -> None:
        """Flag the owning pool's fleet-telemetry row stale. Called on
        entry to and exit from 'backoff' — the only transitions that
        move the retry-ladder signals the FleetSampler columns carry.
        Guarded getattr: ConnectionSet slots hand a cset as 'pool'."""
        dirty = getattr(self.sm_pool, '_telemetry_dirty', None)
        if dirty is not None:
            dirty()

    def set_unwanted(self) -> None:
        """Forward to the current socket if it supports it
        (reference lib/connection-fsm.js:211-222)."""
        sock = self.sm_socket
        if sock is not None and \
                callable(getattr(sock, 'set_unwanted', None)):
            sock.set_unwanted()
        elif sock is not None and \
                callable(getattr(sock, 'setUnwanted', None)):
            sock.setUnwanted()

    setUnwanted = set_unwanted

    # -- signal functions ------------------------------------------------

    def connect(self) -> None:
        assert self.is_in_state('init') or self.is_in_state('closed'), (
            'SocketMgrFSM.connect may only be called in state "init" or '
            '"closed" (is in "%s")' % self.get_state())
        self.emit('connectAsserted')

    def retry(self) -> None:
        assert self.is_in_state('closed') or self.is_in_state('error'), (
            'SocketMgrFSM.retry may only be called in state "closed" or '
            '"error" (is in "%s")' % self.get_state())
        self.emit('retryAsserted')

    def close(self) -> None:
        assert self.is_in_state('connected') or \
            self.is_in_state('backoff'), (
            'SocketMgrFSM.close may only be called in state "connected" '
            'or "backoff" (is in "%s")' % self.get_state())
        self.emit('closeAsserted')

    def get_last_error(self):
        return self.sm_last_error

    getLastError = get_last_error

    def get_socket(self):
        assert self.is_in_state('connected'), (
            'sockets may only be retrieved from SocketMgrFSMs in '
            '"connected" state (is in "%s")' % self.get_state())
        return self.sm_socket

    getSocket = get_socket

    # -- states ----------------------------------------------------------

    def state_init(self, S):
        S.validTransitions(['connecting'])
        S.goto_state_on(self, 'connectAsserted', 'connecting')

    def state_connecting(self, S):
        S.validTransitions(['connected', 'error'])
        self._sm_telemetry_dirty()   # may be leaving 'backoff'
        self.sm_connect_started = mod_utils.current_millis()

        def on_timeout():
            self.sm_last_error = mod_errors.ConnectionTimeoutError(
                self.sm_backend)
            S.gotoState('error')
            self.sm_pool._incr_counter('timeout-during-connect')
        S.timeout(self.sm_timeout, on_timeout)

        self.sm_log.debug('calling constructor to open new connection')
        prof = _prof
        if prof is None:
            self.sm_socket = self.sm_constructor(self.sm_backend)
        else:
            tok = prof.push_phase('socket_wait')
            try:
                self.sm_socket = self.sm_constructor(self.sm_backend)
            finally:
                prof.pop_phase(tok)
        if self.sm_socket is None:
            raise AssertionError('constructor returned no connection')
        self.sm_socket.sm_fsm = self

        S.on(self.sm_socket, 'connect', lambda *a:
             S.gotoState('connected'))

        @_internal
        def on_error(err=None):
            self.sm_last_error = mod_errors.ConnectionError(
                self.sm_backend, 'error', 'connect', err)
            S.gotoState('error')
            self.sm_log.debug('emitted error while connecting: %r', err)
            self.sm_pool._incr_counter('error-during-connect')
        S.on(self.sm_socket, 'error', on_error)

        def on_connect_error(err=None):
            self.sm_last_error = mod_errors.ConnectionError(
                self.sm_backend, 'connectError', 'connect', err)
            S.gotoState('error')
            self.sm_pool._incr_counter('error-during-connect')
        S.on(self.sm_socket, 'connectError', on_connect_error)

        def on_close(*a):
            self.sm_last_error = mod_errors.ConnectionClosedError(
                self.sm_backend)
            S.gotoState('error')
            self.sm_log.debug('closed while connecting')
            self.sm_pool._incr_counter('close-during-connect')
        S.on(self.sm_socket, 'close', on_close)

        def on_conn_timeout(*a):
            self.sm_last_error = mod_errors.ConnectionTimeoutError(
                self.sm_backend)
            S.gotoState('error')
            self.sm_log.debug('timed out while connecting')
            self.sm_pool._incr_counter('timeout-during-connect')
        S.on(self.sm_socket, 'timeout', on_conn_timeout)
        S.on(self.sm_socket, 'connectTimeout', on_conn_timeout)

    def state_connected(self, S):
        S.validTransitions(['error', 'closed'])

        self.sm_log.debug('connected')
        if self.sm_connect_started is not None:
            now = mod_utils.current_millis()
            self.sm_last_connect = (self.sm_connect_started, now)
            self.sm_connect_started = None
            tracer = mod_trace._runtime
            if tracer is not None:
                tracer.connect_done(self.sm_backend.get('key'),
                                    *self.sm_last_connect)
            if mod_wiretap._LEDGER is not None:
                # Key the wire breakdown by the exact floats the
                # tracer just recorded as the connect span, so the
                # phase ledger's socket_wait decomposition can find
                # it again at replay time.
                sock = self.sm_socket
                mod_wiretap._LEDGER.record_connect(
                    getattr(sock, 'wt_transport', 'unknown'),
                    *self.sm_last_connect,
                    getattr(sock, 'wt_marks', None))
        self.reset_backoff()

        @_internal
        def on_error(err=None):
            self.sm_last_error = mod_errors.ConnectionError(
                self.sm_backend, 'error', 'operation', err)
            S.gotoState('error')
            self.sm_pool._incr_counter('error-while-connected')
            self.sm_log.debug('emitted error while connected: %r', err)
        S.on(self.sm_socket, 'error', on_error)
        S.goto_state_on(self.sm_socket, 'close', 'closed')
        S.goto_state_on(self, 'closeAsserted', 'closed')

    def state_error(self, S):
        S.validTransitions(['backoff'])
        if self.sm_socket is not None:
            self.sm_socket.destroy()
        self.sm_socket = None
        S.goto_state_on(self, 'retryAsserted', 'backoff')

    def state_backoff(self, S):
        S.validTransitions(['failed', 'connecting', 'closed'])
        self._sm_telemetry_dirty()   # ladder position becomes visible

        # "retries" means "attempts" in the cueball API; compare to 1
        # (reference lib/connection-fsm.js:365-371).
        if self.sm_retries_left != math.inf and self.sm_retries_left <= 1:
            S.gotoState('failed')
            return

        delay = mod_utils.delay(self.sm_delay, self.sm_delay_spread)

        if self.sm_retries != math.inf:
            self.sm_retries_left -= 1
            self.sm_delay *= 2
            self.sm_timeout *= 2
            if self.sm_timeout > self.sm_max_timeout:
                self.sm_timeout = self.sm_max_timeout
            if self.sm_delay > self.sm_max_delay:
                self.sm_delay = self.sm_max_delay

        S.timeout(delay, lambda: S.gotoState('connecting'))
        S.goto_state_on(self, 'closeAsserted', 'closed')

    def state_closed(self, S):
        S.validTransitions(['backoff', 'connecting'])
        self._sm_telemetry_dirty()   # may be leaving 'backoff'
        if self.sm_socket is not None:
            self.sm_socket.destroy()
        self.sm_socket = None
        self.sm_log.debug('connection closed')
        S.goto_state_on(self, 'retryAsserted', 'backoff')
        S.goto_state_on(self, 'connectAsserted', 'connecting')

    def state_failed(self, S):
        S.validTransitions([])
        self._sm_telemetry_dirty()   # leaving 'backoff'
        self.sm_log.warning(
            'failed to connect to backend, retries exhausted: %r',
            self.sm_last_error)
        self.sm_pool._incr_counter('retries-exhausted')


# ---------------------------------------------------------------------------
# CueBallClaimHandle

class CueBallClaimHandle(FSM):
    """FSM handed out to pool users on claim()
    (reference lib/connection-fsm.js:427-784)."""

    # The on/once overrides below only reject *user* 'readable'/'close'
    # subscriptions; framework-internal state registrations never use
    # those events, so the native core may append them straight to the
    # C listener table (emitter.c emitter_internal_on_fast).
    _cueball_safe_internal_on = True

    def __init__(self, options: dict):
        claim_timeout = options['claimTimeout']
        self.ch_claim_timeout = claim_timeout
        self.ch_pool = options['pool']
        throw_error = options.get('throwError')
        self.ch_throw_error = True if throw_error is None else throw_error

        claim_stack = options['claimStack']
        if not isinstance(claim_stack, str):
            raise AssertionError('options.claimStack must be a string')
        self.ch_claim_stack = _parse_stack(claim_stack)

        callback = options['callback']
        if not callable(callback):
            raise AssertionError('options.callback must be callable')
        self.ch_callback = callback

        # Child logger built lazily: handles log only on unusual paths
        # (leak check, double release), and building a LoggerAdapter on
        # every claim costs ~5% of the claim/release hot path.
        self._ch_log_parent = options.get('log')
        self._ch_log = None

        self.ch_slot = None
        self.ch_waiter_node = None  # pool claim-queue node (O(1) unlink)
        self.ch_requeue = None      # pool try_next; set AFTER init so
        #                             only re-entries to waiting fire it
        self.ch_release_stack: list[str] | None = None
        self.ch_connection = None
        self.ch_pre_listeners: dict[str, int] = {}
        self.ch_pre_epoch = None    # listener epoch at claim snapshot
        self.ch_cancelled = False
        self.ch_last_error = None
        self._ch_arm_timer = None
        self.ch_do_release_leak_check = True
        self.ch_pinger = False
        self.ch_started = mod_utils.current_millis()
        self.ch_trace = None  # ClaimTrace, attached by the pool/set
        #                       when tracing is enabled (trace.py)

        super().__init__('waiting')

    @property
    def ch_log(self):
        if self._ch_log is None:
            self._ch_log = mod_utils.make_child_logger(
                self._ch_log_parent or logging.getLogger(
                    'cueball.claimhandle'),
                component='CueBallClaimHandle')
        return self._ch_log

    # -- misuse traps ----------------------------------------------------
    # Users sometimes mix up the (handle, connection) callback argument
    # order; make treating the handle as a socket fail loudly
    # (reference lib/connection-fsm.js:529-557).

    @property
    def writable(self):
        raise mod_errors.ClaimHandleMisusedError()

    @property
    def readable(self):
        raise mod_errors.ClaimHandleMisusedError()

    def write(self, *a, **kw):
        raise mod_errors.ClaimHandleMisusedError()

    def read(self, *a, **kw):
        raise mod_errors.ClaimHandleMisusedError()

    def on(self, event, listener=None):
        if event in ('readable', 'close'):
            raise mod_errors.ClaimHandleMisusedError()
        return super().on(event, listener)

    def once(self, event, listener=None):
        if event in ('readable', 'close'):
            raise mod_errors.ClaimHandleMisusedError()
        return super().once(event, listener)

    def disable_release_leak_check(self) -> None:
        self.ch_do_release_leak_check = False

    disableReleaseLeakCheck = disable_release_leak_check

    def arm_claim_timer(self) -> None:
        """Called by the pool when this handle parks in the claim
        queue: arm the claim timeout now (see state_waiting — claims
        served without parking never pay for a timer). After arming,
        _ch_arm_timer holds the wheel token instead of the closure."""
        arm = self._ch_arm_timer
        if callable(arm):
            arm()

    def _ch_wheel_fire(self, token) -> None:
        """Deadline bucket fired (runq timer wheel). The wheel rounds
        deadlines UP to the next quantum, so firing is never early;
        stale tokens (this handle re-parked or resolved since) are
        recognized by identity and ignored."""
        if self._ch_arm_timer is not token:
            return
        self._ch_arm_timer = None
        if self.is_in_state('waiting'):
            self.timeout()

    def _ch_unpark(self) -> None:
        """O(1)-unlink this handle's claim-queue node, if parked. Runs
        at entry to every state that leaves 'waiting', so a resolved
        handle never stays pinned in the pool's wait queue until a
        dequeue that may not come (the pool used to do this from a
        per-claim stateChanged listener; owning it here saves that
        subscription on the claim hot path). Also drops the un-fired
        arm closure (it captures the waiting state's handle, and a
        fast-path claim would otherwise pin that for the whole lease)
        or cancels the armed wheel token."""
        tok = self._ch_arm_timer
        self._ch_arm_timer = None
        if type(tok) is tuple:
            mod_runq.wheel_cancel(tok)
        node = self.ch_waiter_node
        if node is not None:
            node.remove()
            self.ch_waiter_node = None
            # The claim queue's head (and so the head sojourn the
            # fleet sampler publishes) may have moved; flag the row.
            # Guarded: ConnectionSet claims hand a cset as 'pool'.
            dirty = getattr(self.ch_pool, '_telemetry_dirty', None)
            if dirty is not None:
                dirty()

    # -- signal functions ------------------------------------------------

    def try_(self, slot: 'ConnectionSlotFSM') -> None:
        assert self.is_in_state('waiting'), (
            'ClaimHandle.try_ may only be called in state "waiting" '
            '(is in "%s")' % self.get_state())
        assert slot.is_in_state('idle'), (
            'ClaimHandle.try_ may only be called on a slot in state '
            '"idle" (is in "%s")' % slot.get_state())
        self.ch_slot = slot
        self.emit('tryAsserted')

    def accept(self, connection) -> None:
        assert self.is_in_state('claiming')
        self.ch_connection = connection
        self.emit('accepted')

    def reject(self) -> None:
        assert self.is_in_state('claiming')
        self.emit('rejected')

    def cancel(self) -> None:
        if self.is_in_state('claimed'):
            self.release()
        else:
            self.ch_cancelled = True
            self.emit('cancelled')

    def timeout(self) -> None:
        assert self.is_in_state('waiting')
        self.emit('timeout')

    def fail(self, err) -> None:
        self.emit('error', err)

    def _relinquish(self, event: str) -> None:
        if not self.is_in_state('claimed'):
            if self.is_in_state('released') or self.is_in_state('closed'):
                # Name the first release's call site. Python stacks are
                # oldest-first (unlike the reference's node stacks), so
                # walk from the END, skipping this package's own capture
                # frames (matched by the package directory, not a bare
                # substring — a repo cloned AS 'cueball_tpu/' must not
                # have its own frames skipped), to reach the releaser.
                import os
                pkg_dir = os.path.dirname(os.path.abspath(__file__)) \
                    + os.sep
                who = 'unknown'
                for line in reversed(self.ch_release_stack or []):
                    s = line.strip()
                    if s.startswith('File "') and \
                            pkg_dir not in s.split(',')[0]:
                        who = s
                        break
                raise RuntimeError(
                    'Connection not claimed by this handle, released '
                    'by %s' % who)
            raise RuntimeError(
                'ClaimHandle.release() called while in state "%s"' %
                self.get_state())
        e = mod_utils.maybe_capture_stack_trace()
        self.ch_release_stack = _parse_stack(e['stack'])
        self.emit(event)

    def release(self) -> None:
        self._relinquish('releaseAsserted')

    def close(self) -> None:
        self._relinquish('closeAsserted')

    def get_last_error(self):
        return self.ch_last_error

    # -- states ----------------------------------------------------------

    def state_waiting(self, S):
        S.validTransitions(['claiming', 'cancelled', 'failed'])

        self.ch_slot = None
        if self.ch_trace is not None:
            # No-op on the first entry; after a rejected handshake it
            # closes the handshake span and opens a new queue_wait.
            self.ch_trace.requeued()
        if self.ch_requeue is not None:
            # Re-entry after a rejected claim: ask the pool to try
            # again next tick (the initial entry runs during __init__,
            # before the pool has installed ch_requeue — the pool
            # schedules that first try itself).  Deliberately NOT
            # S.immediate: the requeue must survive leaving 'waiting'
            # (a claim can be handed out before the tick fires).
            defer(self.ch_requeue)

        S.goto_state_on(self, 'tryAsserted', 'claiming')

        def on_timeout():
            self.ch_last_error = mod_errors.ClaimTimeoutError(self.ch_pool)
            self.ch_pool._incr_counter('claim-timeout')
            S.gotoState('failed')

        # The timeout timer is armed LAZILY, by the pool, only when
        # the handle actually parks in the wait queue
        # (arm_claim_timer): a claim served from the idle queue never
        # waits, and skipping the arm+cancel saves timer churn on
        # every fast-path claim. Armed deadlines go to the runq timer
        # wheel — one shared loop.call_later per 5ms bucket instead of
        # a TimerHandle + timer-heap entry per parked claim; the
        # deadline stays measured from ch_started, so the deferred
        # arm never extends it, and the wheel's fire calls
        # _ch_wheel_fire -> timeout(), handled by on_timeout above.
        t = self.ch_claim_timeout
        if isinstance(t, (int, float)) and math.isfinite(t):
            def _arm():
                self._ch_arm_timer = mod_runq.wheel_arm(
                    self.ch_started + t, self)
            self._ch_arm_timer = _arm
        else:
            # No finite deadline: nothing to arm, so don't make the
            # pool's arm_claim_timer pay for a closure per park.
            self._ch_arm_timer = None

        S.on(self, 'timeout', on_timeout)

        def on_error(err):
            self.ch_last_error = err
            S.gotoState('failed')
        S.on(self, 'error', on_error)

        S.goto_state_on(self, 'cancelled', 'cancelled')

    def state_claiming(self, S):
        S.validTransitions(['claimed', 'waiting', 'cancelled'])

        self._ch_unpark()
        if self.ch_trace is not None:
            self.ch_trace.claiming(self.ch_slot)
        S.goto_state_on(self, 'accepted', 'claimed')

        def on_rejected():
            if self.ch_cancelled:
                S.gotoState('cancelled')
            else:
                S.gotoState('waiting')
        S.on(self, 'rejected', on_rejected)

        self.ch_slot.claim(self)

    def state_claimed(self, S):
        S.validTransitions(['released', 'closed'])

        S.goto_state_on(self, 'releaseAsserted', 'released')
        S.goto_state_on(self, 'closeAsserted', 'closed')

        if self.ch_trace is not None:
            self.ch_trace.claimed()

        if self.ch_cancelled:
            S.gotoState('released')
            return

        conn = self.ch_connection
        epoch = _listener_epoch(conn)
        cached = getattr(conn, '_cueball_listener_counts', None)
        if epoch is not None and cached is not None and \
                cached[0] == epoch:
            # Nobody added/removed an external listener since the last
            # snapshot: reuse it instead of re-walking four listener
            # lists per claim (~7% of a claim/release cycle,
            # docs/claim-path-profile.md round 5).
            self.ch_pre_listeners = cached[1]
        else:
            self.ch_pre_listeners = {
                evt: count_listeners(conn, evt) for evt in _LEAK_EVENTS}
            if epoch is not None:
                try:
                    conn._cueball_listener_counts = (
                        epoch, self.ch_pre_listeners)
                except (AttributeError, TypeError):
                    pass
        self.ch_pre_epoch = epoch

        @_internal
        def on_error(err=None):
            count = count_listeners(self.ch_connection, 'error')
            if count == 0 and self.ch_throw_error:
                # End-user attached no 'error' listener: act like nothing
                # is listening and raise
                # (reference lib/connection-fsm.js:697-709).
                raise err if isinstance(err, BaseException) else \
                    mod_errors.CueBallError(repr(err))
            self.ch_log.warning(
                'connection emitted error while claimed: %r', err)
            self.ch_pool._incr_counter('error-while-claimed')
        S.on(self.ch_connection, 'error', on_error)

        self.ch_callback(None, self, self.ch_connection)

    def state_released(self, S):
        S.validTransitions([])
        if self.ch_trace is not None:
            self.ch_trace.released('release')
        if _HANDLE_FREELIST:
            # After this tick's pump batch (deferred stateChanged
            # emissions included) the handle is inert; recycle it.
            defer(self._ch_recycle)
        if not self.ch_do_release_leak_check:
            return
        conn = self.ch_connection
        epoch = _listener_epoch(conn)
        if epoch is not None and epoch == self.ch_pre_epoch:
            # Zero external listener mutations while claimed: the
            # counts provably match the claim-time snapshot; skip the
            # sweep (a leaker necessarily bumps the epoch).
            return
        new_counts = {}
        for evt in _LEAK_EVENTS:
            new_count = count_listeners(conn, evt)
            new_counts[evt] = new_count
            old_count = self.ch_pre_listeners.get(evt)
            if old_count is not None and new_count > old_count:
                self.ch_log.warning(
                    'connection claimer looks like it leaked event '
                    'handlers: event=%s before=%d after=%d',
                    evt, old_count, new_count)
        if epoch is not None:
            # Refresh the snapshot so the next claim of this
            # connection can skip its pre-count walk too.
            try:
                conn._cueball_listener_counts = (epoch, new_counts)
            except (AttributeError, TypeError):
                pass

    def state_closed(self, S):
        S.validTransitions([])
        # No leak check: the connection is being closed anyway.
        if self.ch_trace is not None:
            self.ch_trace.released('close')
        if _HANDLE_FREELIST:
            defer(self._ch_recycle)

    def state_cancelled(self, S):
        S.validTransitions([])
        self._ch_unpark()
        if self.ch_trace is not None:
            self.ch_trace.cancelled()
        # Public API contract: the callback is never called after
        # cancel() (reference lib/connection-fsm.js:770-777).

    def state_failed(self, S):
        S.validTransitions([])
        self._ch_unpark()
        if self.ch_trace is not None:
            self.ch_trace.failed(self.ch_last_error)
        S.immediate(lambda: self.ch_callback(self.ch_last_error))

    def _ch_recycle(self) -> None:
        """Deferred from the terminal released/closed entries: clear
        every internal reference that could pin pool state (crucially
        ch_requeue — its try_next closure cycles back through the
        pool) and offer the handle to the C freelist. NOT run from
        failed/cancelled: state_failed's deferred callback still needs
        ch_callback, and neither state is worth optimizing."""
        if type(self) is not CueBallClaimHandle:
            return  # subclasses must not resurface as plain handles
        if not (self.is_in_state('released') or
                self.is_in_state('closed')):
            return
        self.ch_requeue = None
        self.ch_callback = None
        self.ch_slot = None
        self.ch_connection = None
        self.ch_waiter_node = None
        self.ch_trace = None
        self.ch_pre_listeners = {}
        _native.handle_free_push(self)


def obtain_claim_handle(options: dict) -> CueBallClaimHandle:
    """Claim-handle factory for the pool hot path: recycle a terminal
    handle from the C freelist when the native engine is loaded
    (re-running __init__ re-enters 'waiting' exactly like a fresh
    construction), else construct one."""
    if _HANDLE_FREELIST:
        h = _native.handle_free_pop()
        if h is not None:
            h.remove_all_listeners()
            h.__init__(options)
            return h
    return CueBallClaimHandle(options)


def arm_claim_timers(handles) -> None:
    """Batched arm_claim_timer for claim_many's park path. A batch
    shares one claimTimeout and its handles were minted in the same
    loop tick, so their deadlines land in (at most one quantum of)
    the same wheel bucket: resolve the bucket once via wheel_arm_many
    instead of per handle. The shared deadline is the LATEST in the
    batch — the wheel may fire a claim a few ms late (inside its
    normal quantum slop), never early."""
    arm = [h for h in handles if callable(h._ch_arm_timer)]
    if not arm:
        return
    deadline = max(h.ch_started for h in arm) + arm[0].ch_claim_timeout
    for h, tok in zip(arm, mod_runq.wheel_arm_many(deadline, arm)):
        h._ch_arm_timer = tok


# ---------------------------------------------------------------------------
# ConnectionSlotFSM

class ConnectionSlotFSM(FSM):
    """One pool/set slot; drives a SocketMgrFSM and reports the
    transitions its Pool or Set cares about
    (reference lib/connection-fsm.js:810-1242)."""

    def __init__(self, options: dict):
        self.csf_pool = options['pool']
        self.csf_backend = options['backend']
        self.csf_wanted = True
        self.csf_handle = None
        self.csf_prev_handle = None
        self.csf_monitor = bool(options['monitor'])

        self.csf_checker = options.get('checker')
        self.csf_check_timeout = options.get('checkTimeout')

        self.csf_log = mod_utils.make_child_logger(
            options.get('log') or logging.getLogger('cueball.slot'),
            component='CueBallConnectionSlotFSM',
            backend=self.csf_backend.get('key'),
            address=self.csf_backend.get('address'),
            port=self.csf_backend.get('port'))

        self.csf_smgr = SocketMgrFSM({
            'pool': options['pool'],
            'constructor': options['constructor'],
            'backend': options['backend'],
            'log': options.get('log'),
            'recovery': options['recovery'],
            'monitor': bool(options['monitor']),
            'slot': self,
        })

        super().__init__('init')

    # -- public interface ------------------------------------------------

    def set_unwanted(self) -> None:
        if self.csf_wanted is False:
            return
        self.csf_wanted = False
        self.csf_smgr.set_unwanted()
        self.emit('unwanted')

    setUnwanted = set_unwanted

    def start(self) -> None:
        assert self.is_in_state('init')
        self.emit('startAsserted')

    def claim(self, handle: CueBallClaimHandle) -> None:
        assert self.is_in_state('idle')
        assert self.csf_handle is None
        self.csf_handle = handle
        self.emit('claimAsserted')

    def make_child_logger(self, *a, **kw):
        return self.csf_log

    makeChildLogger = make_child_logger

    def get_socket_mgr(self) -> SocketMgrFSM:
        return self.csf_smgr

    getSocketMgr = get_socket_mgr

    def get_backend(self) -> dict:
        return self.csf_backend

    getBackend = get_backend

    def is_running_ping(self) -> bool:
        return bool(self.is_in_state('busy') and self.csf_handle and
                    self.csf_handle.ch_pinger)

    isRunningPing = is_running_ping

    # -- states ----------------------------------------------------------

    def state_init(self, S):
        S.validTransitions(['connecting'])
        S.goto_state_on(self, 'startAsserted', 'connecting')

    def state_connecting(self, S):
        S.validTransitions(['failed', 'retrying', 'idle'])
        smgr = self.csf_smgr

        def on_changed(st):
            if st in ('init', 'connecting'):
                pass
            elif st == 'failed':
                S.gotoState('failed')
            elif st == 'error':
                S.gotoState('retrying')
            elif st == 'connected':
                S.gotoState('idle')
            else:
                raise RuntimeError(
                    'Unhandled smgr state transition: .connect() => '
                    '"%s"' % st)
        S.on(smgr, 'stateChanged', on_changed)
        prof = _prof
        if prof is None:
            smgr.connect()
        else:
            tok = prof.push_phase('socket_wait')
            try:
                smgr.connect()
            finally:
                prof.pop_phase(tok)

    def state_failed(self, S):
        S.validTransitions([])
        assert self.csf_smgr.is_in_state('failed'), 'smgr must be failed'

    def state_retrying(self, S):
        S.validTransitions(['idle', 'failed', 'retrying', 'stopped',
                            'stopping'])
        smgr = self.csf_smgr

        def on_changed(st):
            if st in ('backoff', 'connecting'):
                pass
            elif st == 'failed':
                S.gotoState('failed')
            elif st == 'error':
                if self.csf_monitor and not self.csf_wanted:
                    S.gotoState('stopped')
                else:
                    S.gotoState('retrying')
            elif st == 'connected':
                S.gotoState('idle')
            else:
                raise RuntimeError(
                    'Unhandled smgr state transition: .retry() => '
                    '"%s"' % st)
        S.on(smgr, 'stateChanged', on_changed)

        def on_unwanted():
            if self.csf_monitor and smgr.is_in_state('backoff'):
                S.gotoState('stopping')
        S.on(self, 'unwanted', on_unwanted)

        smgr.retry()

    def state_idle(self, S):
        S.validTransitions(['retrying', 'connecting', 'stopping',
                            'stopped', 'busy'])
        smgr = self.csf_smgr

        if self.csf_handle is not None:
            self.csf_prev_handle = self.csf_handle
        self.csf_handle = None

        # Monitor successfully connected: convert to a normal slot
        # (reference lib/connection-fsm.js:1053-1057).
        if self.csf_monitor is True:
            self.csf_monitor = False
            smgr.set_monitor(False)

        def on_unwanted():
            if smgr.is_in_state('connected'):
                S.gotoState('stopping')
            elif smgr.is_in_state('error') or smgr.is_in_state('closed'):
                # The disconnect landed in this same loop turn and its
                # stateChanged is still queued. The reference's guard
                # only handles a connected smgr
                # (lib/connection-fsm.js:1065-1069); with the entry
                # short-circuit below that strands an unwanted slot in
                # 'idle' with no registrations at all — nothing would
                # ever move it again and pool.stop() hangs in
                # 'stopping.backends' (found by tests/test_soak.py).
                # The slot is unwanted and the socket is gone: finish.
                S.gotoState('stopped')

        if not self.csf_wanted:
            on_unwanted()
            return
        S.on(self, 'unwanted', on_unwanted)

        def on_changed(st):
            if st == 'error':
                S.gotoState('retrying')
            elif st == 'closed':
                if not self.csf_wanted:
                    S.gotoState('stopped')
                else:
                    S.gotoState('connecting')
            else:
                raise RuntimeError(
                    'Unhandled smgr state transition: connected => '
                    '"%s"' % st)
        S.on(smgr, 'stateChanged', on_changed)

        S.goto_state_on(self, 'claimAsserted', 'busy')

        if self.csf_check_timeout is not None and \
                self.csf_checker is not None:
            S.timeout(self.csf_check_timeout,
                      lambda: do_ping_check(self, self.csf_checker))

    def state_busy(self, S):
        S.validTransitions(['idle', 'stopping', 'stopped', 'retrying',
                            'killing', 'connecting'])
        smgr = self.csf_smgr
        hdl = self.csf_handle
        # Track the smgr state via events: a disconnect may have happened
        # in this same loop turn and its stateChanged not yet delivered
        # (reference lib/connection-fsm.js:881-889,1130-1139).
        state = {'smgr': 'connected'}

        def on_smgr_changed(st):
            state['smgr'] = st
        S.on(smgr, 'stateChanged', on_smgr_changed)

        def on_release():
            if state['smgr'] == 'connected':
                if self.csf_wanted:
                    S.gotoState('idle')
                else:
                    S.gotoState('stopping')
            elif state['smgr'] == 'closed':
                if self.csf_wanted:
                    S.gotoState('connecting')
                else:
                    S.gotoState('stopped')
            elif state['smgr'] == 'error':
                S.gotoState('retrying')
            else:
                raise RuntimeError(
                    'Handle released while smgr was in unhandled state '
                    '"%s"' % smgr.get_state())

        def on_close():
            if state['smgr'] == 'connected':
                S.gotoState('killing')
            else:
                S.gotoState('retrying')

        def on_hdl_changed(st):
            if st == 'released':
                on_release()
            elif st == 'closed':
                on_close()
        S.on(hdl, 'stateChanged', on_hdl_changed)

        # The smgr may have already left 'connected' by the time we get
        # here; if we lost the race, treat it like a release
        # (reference lib/connection-fsm.js:1183-1196).
        if smgr.is_in_state('connected'):
            sock = smgr.get_socket()
            probe = getattr(sock, 'cb_claim_ready', None)
            if probe is None:
                hdl.accept(sock)
            else:
                # Transport-level claim-readiness probe: a transport
                # that must move bytes before the connection is usable
                # for THIS claim (e.g. netsim trickling TCP segments
                # mid-handshake) exposes cb_claim_ready(done); accept
                # is deferred until done(ok). The handle sits in
                # 'claiming' throughout, so probe time lands in the
                # ledger's handshake phase, not queue_wait. A probe
                # that completes synchronously is byte-identical to
                # the plain accept path. Transports MUST eventually
                # call done — a probed claim cannot time out.
                def on_ready(ok):
                    if self.csf_handle is not hdl or \
                            not hdl.is_in_state('claiming') or \
                            not self.is_in_state('busy'):
                        return
                    if ok and state['smgr'] == 'connected':
                        hdl.accept(sock)
                    else:
                        hdl.reject()
                        self.csf_handle = None
                        on_release()
                probe(on_ready)
        else:
            hdl.reject()
            self.csf_handle = None
            on_release()

    def state_killing(self, S):
        S.validTransitions(['retrying'])
        smgr = self.csf_smgr

        def on_changed(st):
            if st in ('closed', 'error'):
                S.gotoState('retrying')
        S.on(smgr, 'stateChanged', on_changed)

        # The socket may have closed already with the stateChanged event
        # still pending; don't double-close
        # (reference lib/connection-fsm.js:1209-1216).
        if not smgr.is_in_state('closed') and \
                not smgr.is_in_state('error'):
            smgr.close()

    def state_stopping(self, S):
        S.validTransitions(['stopped'])
        smgr = self.csf_smgr

        def on_changed(st):
            if st in ('closed', 'error'):
                S.gotoState('stopped')
        S.on(smgr, 'stateChanged', on_changed)

        if not smgr.is_in_state('closed') and \
                not smgr.is_in_state('error'):
            smgr.close()

    def state_stopped(self, S):
        S.validTransitions([])
        smgr = self.csf_smgr
        assert smgr.is_in_state('closed') or smgr.is_in_state('error') or \
            smgr.is_in_state('failed'), 'smgr must be stopped'


def do_ping_check(fsm: ConnectionSlotFSM, checker) -> None:
    """Run the user health 'checker' over an idle slot by claiming it
    through a private handle (reference lib/connection-fsm.js:1101-1127)."""

    def ping_check_adapter(err, hdl=None, conn=None):
        # Infinite timeout and no .fail(): err is always None here.
        assert err is None
        checker(hdl, conn)

    handle = CueBallClaimHandle({
        'pool': fsm.csf_pool,
        'claimStack': ('Error\n'
                       'at claim\n'
                       'at cueball.do_ping_check\n'
                       'at cueball.do_ping_check\n'),
        'callback': ping_check_adapter,
        'log': fsm.csf_log,
        'claimTimeout': math.inf,
    })
    handle.ch_pinger = True
    # If we lose the race back to 'waiting', just drop the handle
    # (reference lib/connection-fsm.js:1121-1126).
    handle.try_(fsm)
