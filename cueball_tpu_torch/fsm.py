"""Moore finite-state-machine runtime.

Replaces the reference's external `mooremachine` dependency (reference
docs/internals.adoc:115-131). Everything stateful in this framework is an
explicit Moore machine: behaviour is a function of the current state only,
state entry functions register all event handlers for that state through a
disposable handle, and every handler is torn down on state exit. This
"design out the races" discipline is load-bearing: the reference's hardest
bugs were async-ordering races between interacting FSMs (reference
CHANGES.adoc #92 #108 #111 #144), and the survey calls out the ordering
semantics of async `stateChanged` emission as critical (reference
lib/pool.js:938-945, lib/connection-fsm.js:881-889).

Semantics replicated:
- States are methods named ``state_<name>`` taking a :class:`StateHandle`.
  Sub-states (``"stopping.backends"``) map to ``state_stopping_backends``.
- Entering a state synchronously runs its entry function; ``stateChanged``
  is emitted *asynchronously* (loop.call_soon, the setImmediate analogue),
  once per transition, in transition order.
- ``S.on(emitter, event, cb)``, ``S.timeout(ms, cb)``, ``S.interval(ms,
  cb)``, ``S.immediate(cb)`` register disposables that are removed /
  cancelled when the FSM leaves the state; callbacks are additionally
  gated so a stale callback that already fired into the loop is a no-op.
- ``S.validTransitions([...])`` whitelists exits (reference usage e.g.
  lib/pool.js:316); an illegal transition raises.
- State history ring buffer (mooremachine keeps these for core-dump
  debugging; the reference test suite asserts on ``fsm_history``,
  reference test/pool.test.js:373-374).
- A module-level transition-trace hook stands in for mooremachine's
  dtrace USDT probes on transitions (reference docs/internals.adoc:125-131).
"""

from __future__ import annotations

import asyncio
import typing

from .events import EventEmitter, _native
from . import runq
from . import utils as mod_utils

# Module-level transition trace hooks: fn(fsm, old_state, new_state).
# The dtrace-probe analogue (reference docs/internals.adoc:125-131):
# attach a tracer at runtime with add_transition_tracer() and every FSM
# transition in the process reports here with negligible cost when empty.
_TRANSITION_TRACERS: list[typing.Callable] = []

# Bound to the profile module while its sampler runs, so SIGPROF
# samples landing inside a state-entry function attribute to the fsm
# phase (the native engine marks the phase in C; this seam covers the
# pure engine).
_prof = None


def add_transition_tracer(fn: typing.Callable) -> None:
    _TRANSITION_TRACERS.append(fn)


def remove_transition_tracer(fn: typing.Callable) -> None:
    try:
        _TRANSITION_TRACERS.remove(fn)
    except ValueError:
        pass


def get_loop() -> asyncio.AbstractEventLoop:
    try:
        return asyncio.get_running_loop()
    except RuntimeError:
        raise RuntimeError(
            'cueball_tpu_torch FSMs schedule timers and deferred events on '
            'the asyncio event loop; construct and drive them from within '
            'a running loop (e.g. inside asyncio.run())') from None


class _PyStateHandle:
    """Handle passed to each state entry function (pure-Python
    fallback; see the native-backed StateHandle below).

    All registrations made through the handle live exactly as long as the
    FSM remains in the state that created them. Disposables are stored
    raw — an ``(emitter, event, listener)`` tuple or a zero-arg callable
    — to keep the per-transition listener churn cheap (this engine is
    the claim hot path's inner loop).
    """

    __slots__ = ('_fsm', '_state', '_disposables', '_valid',
                 '_transitioned')

    def __init__(self, fsm: 'FSM', state: str):
        self._fsm = fsm
        self._state = state
        self._disposables: list = []
        self._valid: list[str] | None = None
        self._transitioned = False

    # -- liveness --------------------------------------------------------

    def is_current(self) -> bool:
        return self._fsm._fsm_state_handle is self

    # Gates wrap callbacks the framework registers through a StateHandle;
    # they are never user listeners, so they must read as internal to
    # count_listeners (the claimed-connection leak/raise checks,
    # reference lib/connection-fsm.js:786-808).
    def _gate(self, cb: typing.Callable) -> typing.Callable:
        """Wrap cb so it only runs while this state is current."""
        def gated(*args, **kwargs):
            if self.is_current():
                return cb(*args, **kwargs)
            return None
        gated._cueball_internal = True
        return gated

    callback = _gate  # public alias, mooremachine's S.callback()

    # -- registrations ---------------------------------------------------

    def on(self, emitter: EventEmitter, event: str,
           cb: typing.Callable) -> None:
        gated = self._gate(cb)
        emitter.on(event, gated)
        self._disposables.append((emitter, event, gated))

    def _add_disposable(self, d: typing.Callable) -> None:
        self._disposables.append(d)

    # -- transitions -----------------------------------------------------

    def valid_transitions(self, states: list[str]) -> None:
        self._valid = list(states)

    validTransitions = valid_transitions

    def goto_state(self, state: str) -> None:
        if not self.is_current() or self._transitioned:
            # A stale handle must never move the machine (mooremachine
            # throws here too); this is the core race guard. A handle
            # that already requested a transition counts as stale even
            # if the hop is still queued (re-entrant gotoState).
            raise RuntimeError(
                '%s: gotoState(%s) called from stale state handle for '
                'state "%s" (now in "%s")' % (
                    self._fsm, state, self._state, self._fsm.get_state()))
        self._transitioned = True
        self._fsm._goto_state(state)

    gotoState = goto_state

    # -- teardown --------------------------------------------------------

    def _dispose_all(self) -> None:
        # Steal the list before invoking anything: a disposable that
        # re-enters _dispose_all must see a fresh list, not re-run the
        # sequence being iterated (mirrors the C StateHandleBase).
        lst = self._disposables
        self._disposables = []
        for i, d in enumerate(lst):
            try:
                if type(d) is tuple:
                    d[0].remove_listener(d[1], d[2])
                else:
                    d()
            except BaseException:
                # Keep the not-yet-run disposables reachable for a
                # retry rather than leaking their registrations.
                self._disposables.extend(lst[i:])
                raise


class _TimerRegistrationsMixin:
    """Timer/scheduling registrations shared by both StateHandle
    implementations, built on _gate/_add_disposable/is_current."""

    __slots__ = ()

    def timeout(self, ms: float, cb: typing.Callable) -> object:
        loop = get_loop()
        handle = loop.call_later(ms / 1000.0, self._gate(cb))
        self._add_disposable(handle.cancel)
        return handle

    def interval(self, ms: float, cb: typing.Callable) -> object:
        loop = get_loop()
        state = {'handle': None, 'cancelled': False}
        gated = self._gate(cb)

        def fire():
            if state['cancelled'] or not self.is_current():
                return
            gated()
            if not state['cancelled'] and self.is_current():
                state['handle'] = loop.call_later(ms / 1000.0, fire)

        state['handle'] = loop.call_later(ms / 1000.0, fire)

        def cancel():
            state['cancelled'] = True
            if state['handle'] is not None:
                state['handle'].cancel()

        self._add_disposable(cancel)
        return state

    def immediate(self, cb: typing.Callable) -> None:
        # The gate already makes the callback a no-op once the state is
        # exited, so the deferral rides the shared engine pump (one
        # scheduled callback per tick) with no cancel disposable needed.
        get_loop()  # fail fast with the helpful no-loop message
        runq.defer(self._gate(cb))

    def goto_state_on(self, emitter: EventEmitter, event: str,
                      state: str) -> None:
        self.on(emitter, event, lambda *a: self.goto_state(state))

    gotoStateOn = goto_state_on

    def goto_state_timeout(self, ms: float, state: str) -> None:
        self.timeout(ms, lambda: self.goto_state(state))

    gotoStateTimeout = goto_state_timeout


if _native is None:
    class StateHandle(_TimerRegistrationsMixin, _PyStateHandle):
        __slots__ = ()
else:
    class StateHandle(_TimerRegistrationsMixin,
                      _native.StateHandleBase):
        """Native-backed state handle: gate construction, listener
        registration/disposal bookkeeping, and the stale-handle
        transition guard run in C (native/emitter.c StateHandleBase);
        timer registrations remain in Python via the mixin."""
        __slots__ = ()

        # The C goto_state_on (closure-free GotoGate) must win over the
        # mixin's lambda-based version in the MRO.
        goto_state_on = _native.StateHandleBase.goto_state_on
        gotoStateOn = goto_state_on


def _state_method_name(state: str) -> str:
    return 'state_' + state.replace('.', '_')


class FSM(EventEmitter):
    """Base Moore machine.

    Subclasses define ``state_<name>(self, S)`` entry methods and call
    ``super().__init__(initial_state)``; the initial state is entered
    synchronously during construction.
    """

    HISTORY_LENGTH = 8

    def __init__(self, initial_state: str):
        super().__init__()
        self._fsm_state: str | None = None
        self._fsm_state_handle: StateHandle | None = None
        self._fsm_history: list[str] = []
        self._fsm_history_at: list[float] = []
        self._fsm_all_state_events: list[str] = []
        self._fsm_in_transition = False
        self._fsm_pending: list[str] = []
        self._goto_state(initial_state)

    # -- introspection ---------------------------------------------------

    def get_state(self) -> str:
        assert self._fsm_state is not None
        return self._fsm_state

    getState = get_state

    def is_in_state(self, state: str) -> bool:
        """True if in `state` or one of its sub-states."""
        cur = self._fsm_state
        if cur is None:
            return False
        if cur == state:
            return True
        # Sub-state check without the `state + '.'` concat (this runs
        # ~14x per claim/release cycle).
        n = len(state)
        return len(cur) > n and cur[n] == '.' and cur.startswith(state)

    isInState = is_in_state

    def get_history(self) -> list[str]:
        return list(self._fsm_history)

    def get_history_timed(self) -> list[tuple[str, float]]:
        """History with entry timestamps (epoch ms) — the debugging
        aid reference changelog #119 added via mooremachine (how long
        did each state, e.g. a claim's 'waiting', actually take)."""
        return list(zip(self._fsm_history, self._fsm_history_at))

    # -- all-state events ------------------------------------------------

    def all_state_event(self, event: str) -> None:
        """Declare an event every state must handle (mooremachine's
        allStateEvent). Emitting it with no registered listener raises,
        which converts a silently-dropped signal into a crash."""
        self._fsm_all_state_events.append(event)

    allStateEvent = all_state_event

    if _native is None:
        # With the native core, the undelivered-all-state-event crash
        # is enforced inside EventEmitter.emit itself (emitter.c
        # emit_check_all_state); no Python override needed.
        def emit(self, event: str, *args) -> bool:
            delivered = super().emit(event, *args)
            if not delivered and event in self._fsm_all_state_events:
                raise RuntimeError(
                    '%r: event "%s" (declared all-state) emitted in '
                    'state "%s" with no handler' % (
                        self, event, self._fsm_state))
            return delivered

    # -- transitions -----------------------------------------------------

    def _check_transition(self, state: str) -> None:
        handle = self._fsm_state_handle
        if handle is not None and handle._valid is not None:
            if state not in handle._valid:
                raise RuntimeError(
                    '%r: invalid transition "%s" -> "%s" (valid: %r)' % (
                        self, self._fsm_state, state, handle._valid))

    def _py_goto_state(self, state: str) -> None:
        self._check_transition(state)

        # Re-entrant gotoState (a state entry function that transitions
        # from within itself) is serialized: queue and run after the
        # current entry completes, preserving transition order. Queued
        # hops are re-validated against the whitelist of the state they
        # actually depart from, at departure time.
        if self._fsm_in_transition:
            self._fsm_pending.append(state)
            return

        self._fsm_in_transition = True
        try:
            self._run_transition(state)
            while self._fsm_pending:
                nxt = self._fsm_pending.pop(0)
                self._check_transition(nxt)
                self._run_transition(nxt)
        finally:
            self._fsm_in_transition = False
            # A failed transition must not leave stale queued hops to
            # replay on a later, unrelated goto_state.
            self._fsm_pending.clear()

    def _py_run_transition(self, state: str) -> None:
        old = self._fsm_state
        if self._fsm_state_handle is not None:
            self._fsm_state_handle._dispose_all()
            self._fsm_state_handle = None

        # Per-class cache of state-name -> unbound entry function; the
        # string munge + getattr is measurable on the claim hot path.
        cls = type(self)
        cache = cls.__dict__.get('_fsm_entry_cache')
        if cache is None:
            cache = {}
            cls._fsm_entry_cache = cache
        entry = cache.get(state)
        if entry is None:
            entry = getattr(cls, _state_method_name(state), None)
            if entry is None:
                raise RuntimeError(
                    '%r: unknown state "%s"' % (self, state))
            cache[state] = entry

        self._fsm_state = state
        self._fsm_history.append(state)
        self._fsm_history_at.append(
            mod_utils.wall_time() * 1000.0)
        if len(self._fsm_history) > self.HISTORY_LENGTH:
            del self._fsm_history[0]
            del self._fsm_history_at[0]

        new_handle = StateHandle(self, state)
        self._fsm_state_handle = new_handle

        for tracer in _TRANSITION_TRACERS:
            tracer(self, old, state)

        prof = _prof
        if prof is None:
            entry(self, new_handle)
        else:
            tok = prof.push_phase('fsm')
            try:
                entry(self, new_handle)
            finally:
                prof.pop_phase(tok)

        # Async (setImmediate-analogue) stateChanged emission; ordering
        # across rapid transitions is preserved by the pump's FIFO.
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            # No loop (e.g. pure-unit tests of sync FSMs): emit inline.
            self.emit('stateChanged', state)
        else:
            runq.defer(self.emit, 'stateChanged', state)

    if _native is None:
        _goto_state = _py_goto_state
        _run_transition = _py_run_transition
    else:
        def _goto_state(self, state: str) -> None:
            # C port of _py_goto_state (native/emitter.c
            # fsm_goto_state): whitelist check, re-entrant transition
            # serialization, and finally-cleanup all run in C. The
            # Python body above remains the reference semantics and
            # the CUEBALL_NO_NATIVE fallback. fsm_configure() hands
            # this exact function to C so StateHandle.goto_state can
            # skip the wrapper when it is not overridden.
            _native.fsm_goto_state(self, state)

        def _run_transition(self, state: str) -> None:
            # C port of _py_run_transition (native/emitter.c
            # fsm_run_transition); the Python body above remains the
            # reference semantics and the CUEBALL_NO_NATIVE fallback.
            _native.fsm_run_transition(self, state)

    def __repr__(self) -> str:
        return '<%s state=%s>' % (type(self).__name__, self._fsm_state)


if _native is not None:
    # The C is_in_state (emitter.c Emitter_is_in_state) is a frameless
    # C call for the single most-called predicate on the claim path;
    # semantics match the Python body above exactly.
    FSM.is_in_state = _native.EventEmitter.is_in_state
    FSM.isInState = _native.EventEmitter.is_in_state
    # Inject the Python-side pieces the C transition engine needs: the
    # concrete StateHandle class, the (shared, mutable) tracer list,
    # asyncio's running-loop accessor, and the stock transition
    # functions (so the C engine runs its inlined ports only for
    # classes that do NOT override them — a subclass _goto_state,
    # _check_transition, or _run_transition is always dispatched).
    _native.fsm_configure(StateHandle, _TRANSITION_TRACERS,
                          asyncio.get_running_loop, FSM._goto_state,
                          FSM._check_transition, FSM._run_transition)
