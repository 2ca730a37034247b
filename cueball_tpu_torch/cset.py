"""ConnectionSet: pool variant for multiplexed protocols.

Rebuild of reference `lib/set.js`. Where a Pool hands out exclusive
claims, a Set maintains at most one connection per distinct backend
(singleton planning) and advertises whole connections to the consumer via
'added'(key, conn, handle) / 'removed'(key, conn, handle) events; the
consumer drains and then releases/closes the handle. Used for protocols
that multiplex many requests over one socket (LDAP, HTTP/2, custom RPC)
where claim/release bookkeeping per request makes no sense
(reference docs/api.adoc for ConnectionSet; lib/set.js:34-140).

Key behaviors preserved:
- serial-numbered connection keys `key + '.' + serial`
  (reference lib/set.js:480-535)
- never deliberately remove the last working connection
  (reference lib/set.js:417-435)
- `assert_emit` crash-if-unhandled for 'added'/'removed'
  (reference lib/set.js:471-479)
- `set_target()` dynamic resize (reference lib/set.js:351-355)
- consumer-driven drain: 'removed' is emitted, then the consumer calls
  handle.release()/close() when the connection is actually drained.
"""

from __future__ import annotations

import logging
import math

from . import trace as mod_trace
from . import utils as mod_utils
from .connection_fsm import ConnectionSlotFSM, obtain_claim_handle
from .events import EventEmitter
from .fsm import FSM
from .pool import _Interval
from .runq import defer


class ConnectionSet(FSM):
    """Reference CueBallConnectionSet (lib/set.js:34-140)."""

    def __init__(self, options: dict):
        if not isinstance(options, dict):
            raise AssertionError('options must be a dict')
        constructor = options.get('constructor')
        # Same transport seam as ConnectionPool: options['transport']
        # supplies the constructor when none is passed explicitly.
        self.cs_transport = None
        if options.get('transport') is not None:
            from . import transport as mod_transport
            self.cs_transport = mod_transport.get_transport(
                options['transport'])
            if constructor is None:
                constructor = self.cs_transport.connector
        if not callable(constructor):
            raise AssertionError('options.constructor must be callable')

        self.cs_uuid = mod_utils.make_uuid()
        self.cs_constructor = constructor

        if options.get('resolver') is None:
            raise AssertionError('options.resolver is required')
        self.cs_resolver = options['resolver']

        recovery = options.get('recovery')
        mod_utils.assert_recovery_set(recovery or {})
        if not recovery or 'default' not in recovery:
            raise AssertionError('options.recovery.default is required')
        self.cs_recovery = recovery

        self.cs_conn_handles_err = bool(
            options.get('connectionHandlesError'))

        self.cs_log = mod_utils.make_child_logger(
            options.get('log') or logging.getLogger('cueball.cset'),
            component='CueBallConnectionSet',
            domain=options.get('domain'),
            service=options.get('service'), cset=self.cs_uuid)
        self.cs_domain = options.get('domain')

        self.cs_collector = mod_utils.create_error_metrics(options)

        target = options.get('target')
        maximum = options.get('maximum')
        if not isinstance(target, int) or not isinstance(maximum, int):
            raise AssertionError(
                'options.target and options.maximum must be numbers')
        self.cs_target = target
        self.cs_max = maximum

        self.cs_keys: list[str] = []
        self.cs_backends: dict[str, dict] = {}
        self.cs_fsm: dict[str, ConnectionSlotFSM] = {}
        self.cs_dead: dict[str, bool] = {}

        # Serial numbers generate per-connection keys
        # (reference lib/set.js:80-95).
        self.cs_serials: dict[str, int] = {}
        self.cs_connections: dict[str, object] = {}
        self.cs_connection_keys: dict[str, list[str]] = {}
        self.cs_lconns: dict[str, 'LogicalConnection'] = {}

        self.cs_last_rebalance = None
        self.cs_in_rebalance = False
        self.cs_rebal_scheduled = False
        self.cs_counters: dict[str, int] = {}
        self.cs_last_error = None

        self.cs_rebal_timer = EventEmitter()
        self.cs_rebal_timer_inst = _Interval(10000, self.cs_rebal_timer)

        shuffle_intvl = options.get('decoherenceInterval')
        if shuffle_intvl is None or shuffle_intvl < 60:
            shuffle_intvl = 60
        self.cs_shuffle_timer = EventEmitter()
        self.cs_shuffle_timer_inst = _Interval(
            shuffle_intvl * 1000, self.cs_shuffle_timer)

        super().__init__('starting')

    # -- resolver plumbing ------------------------------------------------

    def on_resolver_added(self, k: str, backend: dict) -> None:
        backend['key'] = k
        assert k not in self.cs_keys, 'Resolver key is a duplicate'
        idx = mod_utils.get_rng().randrange(len(self.cs_keys) + 1)
        self.cs_keys.insert(idx, k)
        self.cs_backends[k] = backend
        self.rebalance()

    def on_resolver_removed(self, k: str) -> None:
        assert k in self.cs_keys, \
            'Resolver removed key that is not present in cs_keys'
        self.cs_keys.remove(k)
        self.cs_backends.pop(k, None)
        self.cs_dead.pop(k, None)

        fsm = self.cs_fsm.get(k)
        if fsm is not None:
            fsm.set_unwanted()

        for ck in list(self.cs_connection_keys.get(k) or []):
            lconn = self.cs_lconns[ck]
            if not lconn.is_in_state('stopped'):
                lconn.drain()

    def is_declared_dead(self, backend: str) -> bool:
        return self.cs_dead.get(backend) is True

    isDeclaredDead = is_declared_dead

    def should_retry_backend(self, backend: str) -> bool:
        return backend in self.cs_backends

    # -- states ------------------------------------------------------------

    def state_starting(self, S):
        S.validTransitions(['failed', 'running', 'stopping'])
        from .monitor import pool_monitor
        pool_monitor.register_set(self)

        S.on(self.cs_resolver, 'added', self.on_resolver_added)
        S.on(self.cs_resolver, 'removed', self.on_resolver_removed)

        if self.cs_resolver.is_in_state('failed'):
            self.cs_log.warning('resolver has already failed, cset will '
                                'start up in "failed" state')
            self.cs_last_error = self.cs_resolver.get_last_error()
            S.gotoState('failed')
            return

        def on_res_changed(st):
            if st == 'failed':
                self.cs_log.warning(
                    'underlying resolver failed, moving cset to '
                    '"failed" state')
                self.cs_last_error = self.cs_resolver.get_last_error()
                S.gotoState('failed')
        S.on(self.cs_resolver, 'stateChanged', on_res_changed)

        if self.cs_resolver.is_in_state('running'):
            for k, backend in self.cs_resolver.list().items():
                self.on_resolver_added(k, backend)

        S.on(self, 'connectedToBackend', lambda *a:
             S.gotoState('running'))

        def on_closed_backend(*a):
            dead = len(self.cs_dead)
            if dead >= len(self.cs_keys):
                self.cs_log.warning(
                    'cset has exhausted all retries, now moving to '
                    '"failed" state (%d dead)', dead)
                S.gotoState('failed')
        S.on(self, 'closedBackend', on_closed_backend)

        S.goto_state_on(self, 'stopAsserted', 'stopping')

    def state_failed(self, S):
        S.validTransitions(['running', 'stopping'])
        S.on(self.cs_resolver, 'added', self.on_resolver_added)
        S.on(self.cs_resolver, 'removed', self.on_resolver_removed)
        S.on(self.cs_shuffle_timer, 'timeout', self.reshuffle)

        def on_connected(*a):
            assert not self.cs_resolver.is_in_state('failed')
            self.cs_log.info('successfully connected to a backend, '
                             'moving back to running state')
            S.gotoState('running')
        S.on(self, 'connectedToBackend', on_connected)

        S.goto_state_on(self, 'stopAsserted', 'stopping')

        # Pending-event re-check (same race as the pool's failed state):
        # a connection that reached 'idle'/'busy' in this loop turn
        # emitted connectedToBackend before we started listening.
        for fsm in self.cs_fsm.values():
            if fsm.is_in_state('idle') or fsm.is_in_state('busy'):
                self.cs_log.info(
                    'entered failed with a live connection already up; '
                    'returning to running')
                S.gotoState('running')
                return

    def state_running(self, S):
        S.validTransitions(['failed', 'stopping'])
        S.on(self.cs_resolver, 'added', self.on_resolver_added)
        S.on(self.cs_resolver, 'removed', self.on_resolver_removed)
        S.on(self.cs_rebal_timer, 'timeout', self.rebalance)
        S.on(self.cs_shuffle_timer, 'timeout', self.reshuffle)

        def on_closed_backend(*a):
            dead = len(self.cs_dead)
            if dead >= len(self.cs_keys):
                self.cs_log.warning(
                    'cset has exhausted all retries, now moving to '
                    '"failed" state (%d dead)', dead)
                S.gotoState('failed')
        S.on(self, 'closedBackend', on_closed_backend)

        S.goto_state_on(self, 'stopAsserted', 'stopping')

    def state_stopping(self, S):
        S.validTransitions(['stopped'])
        fsms = list(self.cs_fsm.values())
        self.cs_backends = {}
        remaining = {'n': len(fsms)}

        def done_one():
            remaining['n'] -= 1
            if remaining['n'] == 0:
                S.gotoState('stopped')

        if not fsms:
            S.immediate(lambda: S.gotoState('stopped'))
            return

        for fsm in fsms:
            k = fsm.csf_backend['key']
            cks = list(self.cs_connection_keys.get(k) or [])

            if fsm.is_in_state('stopped') or fsm.is_in_state('failed'):
                done_one()
            else:
                def on_changed(s, _fsm=fsm):
                    if s in ('stopped', 'failed'):
                        done_one()
                S.on(fsm, 'stateChanged', on_changed)
                fsm.set_unwanted()

            # Drain advertised connections async, avoiding FSM loops when
            # stop() is called from an 'added' handler
            # (reference lib/set.js:306-317).
            for ck in cks:
                def drain_one(_ck=ck):
                    lconn = self.cs_lconns.get(_ck)
                    if lconn is not None and \
                            not lconn.is_in_state('stopped'):
                        lconn.drain()
                # Deliberately NOT S.immediate: the drain must still run
                # if the set reaches 'stopped' before the tick fires.
                defer(drain_one)

    def state_stopped(self, S):
        S.validTransitions([])
        from .monitor import pool_monitor
        pool_monitor.unregister_set(self)
        self.cs_keys = []
        self.cs_fsm = {}
        self.cs_connections = {}
        self.cs_backends = {}
        self.cs_rebal_timer_inst.cancel()
        self.cs_shuffle_timer_inst.cancel()

    # -- public interface --------------------------------------------------

    def reshuffle(self) -> None:
        if len(self.cs_keys) <= 1:
            return
        taken = self.cs_keys.pop()
        idx = mod_utils.get_rng().randrange(len(self.cs_keys) + 1)
        if len(self.cs_keys) > self.cs_target and idx < self.cs_target:
            self.cs_log.info('random shuffle puts backend "%s" at idx %d',
                             taken, idx)
        self.cs_keys.insert(idx, taken)
        self.rebalance()

    def stop(self) -> None:
        self.emit('stopAsserted')

    def set_target(self, target: int) -> None:
        """Dynamically resize the set (reference lib/set.js:351-355)."""
        self.cs_target = target
        self.rebalance()

    setTarget = set_target

    def get_last_error(self):
        return self.cs_last_error

    getLastError = get_last_error

    def get_connections(self) -> list:
        """Currently-advertised live connections."""
        conns = []
        for lconn in self.cs_lconns.values():
            if lconn.is_in_state('advertised'):
                conns.append(lconn.lc_conn)
        return conns

    getConnections = get_connections

    def _incr_counter(self, counter: str) -> None:
        mod_utils.update_error_metrics(
            self.cs_collector, self.cs_uuid, counter)
        self.cs_counters[counter] = self.cs_counters.get(counter, 0) + 1

    _incrCounter = _incr_counter

    def assert_emit(self, event, *args) -> bool:
        """Emit that crashes if unhandled: Sets are useless without
        'added'/'removed' consumers (reference lib/set.js:471-479)."""
        if self.listener_count(event) < 1:
            raise RuntimeError('Event "%s" on ConnectionSet must be '
                               'handled' % event)
        return self.emit(event, *args)

    assertEmit = assert_emit

    # -- rebalancing -------------------------------------------------------

    def rebalance(self, *_a) -> None:
        if len(self.cs_keys) < 1:
            return
        if self.is_in_state('stopping') or self.is_in_state('stopped'):
            return
        if self.cs_rebal_scheduled is not False:
            return
        self.cs_rebal_scheduled = True
        defer(self._rebalance)

    def _rebalance(self) -> None:
        """Singleton-mode planning over one-slot-per-backend
        (reference lib/set.js:385-469)."""
        if self.cs_in_rebalance is not False:
            return
        self.cs_in_rebalance = True
        self.cs_rebal_scheduled = False

        conns: dict[str, list] = {}
        total = 0
        working = 0
        for k in self.cs_keys:
            conns[k] = []
            fsm = self.cs_fsm.get(k)
            if fsm is not None:
                conns[k].append(fsm)
                if fsm.is_in_state('busy') or fsm.is_in_state('idle'):
                    working += 1
                total += 1

        plan = mod_utils.plan_rebalance(
            conns, self.cs_dead, self.cs_target, self.cs_max, True)

        if plan['remove'] or plan['add']:
            self.cs_log.debug(
                'rebalancing cset, remove %d, add %d (target = %d, '
                'total = %d)', len(plan['remove']), len(plan['add']),
                self.cs_target, total)

        for fsm in plan['remove']:
            # Never deliberately remove the last working connection
            # (reference lib/set.js:417-435).
            if (fsm.is_in_state('busy') or fsm.is_in_state('idle')) and \
                    working <= 1:
                continue

            k = fsm.csf_backend['key']
            if fsm.is_in_state('busy') or fsm.is_in_state('idle'):
                working -= 1
            fsm.set_unwanted()

            if fsm.is_in_state('stopped') or fsm.is_in_state('failed'):
                self.cs_fsm.pop(k, None)
                total -= 1

            for ck in list(self.cs_connection_keys.get(k) or []):
                lconn = self.cs_lconns[ck]
                if not lconn.is_in_state('stopped'):
                    lconn.drain()

        for k in plan['add']:
            total += 1
            if total > (self.cs_max + 1):
                continue
            # Never more than one slot per backend.
            if k in self.cs_fsm:
                continue
            self.add_connection(k)

        self.cs_in_rebalance = False
        self.cs_last_rebalance = mod_utils.wall_time()

    def create_logi_conn(self, key: str) -> None:
        """Allocate the next serial-numbered logical connection for a
        backend slot (reference lib/set.js:480-535)."""
        fsm = self.cs_fsm[key]
        if key not in self.cs_serials:
            self.cs_serials[key] = 1
        self.cs_connection_keys.setdefault(key, [])

        serial = self.cs_serials[key]
        self.cs_serials[key] += 1
        ckey = '%s.%d' % (key, serial)
        self.cs_connection_keys[key].append(ckey)

        lconn = LogicalConnection({
            'set': self,
            'log': self.cs_log,
            'key': key,
            'ckey': ckey,
            'fsm': fsm,
        })
        self.cs_lconns[ckey] = lconn

        def on_changed(st):
            if st != 'stopped':
                return
            # Clean up, then roll the serial if this slot may produce
            # another connection.
            self.cs_lconns.pop(ckey, None)
            cks = self.cs_connection_keys[key]
            assert ckey in cks
            cks.remove(ckey)

            if key not in self.cs_backends:
                return
            if fsm.is_in_state('failed') or fsm.is_in_state('stopped'):
                return
            self.create_logi_conn(key)
        lconn.on('stateChanged', on_changed)

    def add_connection(self, key: str) -> None:
        if self.is_in_state('stopping') or self.is_in_state('stopped'):
            return

        backend = self.cs_backends[key]
        backend['key'] = key

        fsm = ConnectionSlotFSM({
            'constructor': self.cs_constructor,
            'backend': backend,
            'log': self.cs_log,
            'pool': self,
            'recovery': self.cs_recovery,
            'monitor': self.cs_dead.get(key) is True,
        })
        assert key not in self.cs_fsm
        self.cs_fsm[key] = fsm

        self.create_logi_conn(key)

        # Rebalance when a slot reaches or leaves idle — the points where
        # planning can meaningfully change (reference lib/set.js:558-585).
        state = {'was_idle': False}

        def on_changed(new_state):
            if new_state == 'idle':
                self.emit('connectedToBackend', key, fsm)
                if key in self.cs_dead:
                    del self.cs_dead[key]
                self.rebalance()
                state['was_idle'] = True
                return

            if state['was_idle']:
                state['was_idle'] = False
                self.rebalance()

            if new_state == 'failed':
                # No dead flag for backends gone from the resolver.
                if key in self.cs_backends:
                    self.cs_dead[key] = True
                    err = fsm.get_socket_mgr().get_last_error()
                    if err is not None:
                        self.cs_last_error = err

            if new_state in ('stopped', 'failed'):
                self.cs_fsm.pop(key, None)
                self.emit('closedBackend', fsm)
                self.rebalance()

        fsm.on('stateChanged', on_changed)
        fsm.start()

    addConnection = add_connection


class LogicalConnection(FSM):
    """Per-connection-key lifecycle in a Set:
    init -> advertised -> draining -> stopped
    (reference lib/set.js:632-820). Emits 'added'/'removed' on the Set at
    exactly the right times and owns the ClaimHandle."""

    def __init__(self, options: dict):
        self.lc_set = options['set']
        self.lc_key = options['key']
        self.lc_fsm = options['fsm']
        self.lc_smgr = options['fsm'].get_socket_mgr()
        self.lc_conn = None
        self.lc_ckey = options['ckey']
        self.lc_hdl = None
        self.lc_log = options['log']
        super().__init__('init')

    def drain(self) -> None:
        assert not self.is_in_state('stopped')
        self.emit('drainAsserted')

    def state_init(self, S):
        S.validTransitions(['advertised', 'stopped'])

        def on_claimed(err, hdl=None, conn=None):
            assert not err
            assert hdl is self.lc_hdl
            self.lc_conn = conn
            S.gotoState('advertised')

        self.lc_hdl = obtain_claim_handle({
            'pool': self.lc_set,
            'claimStack': ('Error\n'
                           ' at claim\n'
                           ' at ConnectionSet.add_connection\n'
                           ' at ConnectionSet.add_connection'),
            'callback': S.callback(on_claimed),
            'log': self.lc_log,
            'throwError': not self.lc_set.cs_conn_handles_err,
            'claimTimeout': math.inf,
        })
        tracer = mod_trace._runtime
        if tracer is not None:
            # Set claims trace too (the ConnectionSet stands in as the
            # 'pool'; ClaimTrace getattr-guards every pool access).
            tracer.claim_begin(self.lc_hdl, self.lc_set)

        # Keep trying until claimed; fine to retry here since 'added' has
        # not been emitted yet for this ckey
        # (reference lib/set.js:735-757).
        def on_hdl_changed(st):
            if st == 'waiting' and self.lc_hdl.is_in_state('waiting'):
                if self.lc_fsm.is_in_state('idle'):
                    self.lc_hdl.try_(self.lc_fsm)
            elif st in ('failed', 'cancelled'):
                S.gotoState('stopped')
        S.on(self.lc_hdl, 'stateChanged', on_hdl_changed)

        def on_fsm_changed(st):
            if st == 'idle' and self.lc_fsm.is_in_state('idle'):
                if self.lc_hdl.is_in_state('waiting'):
                    self.lc_hdl.try_(self.lc_fsm)
            elif st == 'failed':
                S.gotoState('stopped')
        S.on(self.lc_fsm, 'stateChanged', on_fsm_changed)

        # Drained before ever advertising: straight to stopped.
        S.goto_state_on(self, 'drainAsserted', 'stopped')

    def state_advertised(self, S):
        S.validTransitions(['draining', 'stopped'])

        # Users may .close() at any time, but .release() only after
        # 'removed' (reference lib/set.js:757-791, docs/api.adoc).
        def on_hdl_changed(st):
            if st == 'closed':
                S.gotoState('stopped')
            elif st == 'released':
                raise RuntimeError(
                    'The .release() method may not be called on a '
                    'ConnectionSet handle before "removed" has been '
                    'emitted')
        S.on(self.lc_hdl, 'stateChanged', on_hdl_changed)

        def on_smgr_changed(st):
            if st != 'connected':
                S.gotoState('draining')
        S.on(self.lc_smgr, 'stateChanged', on_smgr_changed)

        S.goto_state_on(self, 'drainAsserted', 'draining')

        self.lc_set.assert_emit(
            'added', self.lc_ckey, self.lc_conn, self.lc_hdl)

    def state_draining(self, S):
        S.validTransitions(['stopped'])

        def on_hdl_changed(st):
            if st in ('closed', 'released', 'cancelled'):
                S.gotoState('stopped')
        S.on(self.lc_hdl, 'stateChanged', on_hdl_changed)

        self.lc_set.assert_emit(
            'removed', self.lc_ckey, self.lc_conn, self.lc_hdl)

    def state_stopped(self, S):
        S.validTransitions([])
        if self.lc_hdl is not None and (
                self.lc_hdl.is_in_state('waiting') or
                self.lc_hdl.is_in_state('claiming')):
            self.lc_hdl.cancel()
