"""Shard workers: one event loop per shard, plus the lifecycle FSM; this
package's copy of the JAX package's ``shard.worker``.

A shard is an asyncio loop that owns a disjoint set of pools. Three
backends implement the same small surface (``launch`` / ``run`` /
``request_stop`` / ``alive`` / ``is_stopped``):

- ``ThreadWorker`` (default): a daemon thread running its own loop.
  The runq pump and the trace recorder are both per-loop /
  GIL-serialized already, so nothing else needs to know.
- ``InlineWorker``: shares the caller's loop. Exists for netsim — a
  virtual-time scenario cannot free-run real threads — and gives the
  router a zero-thread mode where routing is a dict lookup plus a
  direct call.
- ``ProcWorker`` (in ``proc.py``): a ``spawn`` child process, the only
  backend that escapes the GIL for CPU-bound claim traffic.

The ``ShardFSM`` runs on the ROUTER's loop and models the worker's
lifecycle; the worker signals it strictly via
``loop.call_soon_threadsafe`` so no FSM method ever executes off the
router loop. Every cross-loop completion is tracked in a pending table
that is failed with ``ShardDeadError`` the moment the shard's loop
exits, which is what guarantees a claim in flight on a dying shard
errors out instead of deadlocking.
"""

from __future__ import annotations

import asyncio
import importlib
import os
import threading

from ..errors import ShardDeadError
from ..fsm import FSM

START_TIMEOUT_MS = 10_000.0
DRAIN_TIMEOUT_MS = 10_000.0
# How often the running-state watchdog polls thread/process liveness
# and the draining state polls for loop exit.
WATCHDOG_MS = 500.0
DRAIN_POLL_MS = 10.0


def resolve_job(spec):
    """A job is either a callable or a ``'module:function'`` spec
    string (the only form a spawn child can receive — closures don't
    pickle), such as ``'cueball_tpu_torch.shard.proc:_ping'``."""
    if callable(spec):
        return spec
    mod, sep, name = spec.partition(':')
    if not sep or not mod or not name:
        raise ValueError('job spec must be "module:function", got %r'
                         % (spec,))
    fn = getattr(importlib.import_module(mod), name)
    if not callable(fn):
        raise TypeError('job spec %r is not callable' % (spec,))
    return fn


def _try_set_affinity(core) -> bool:
    if core is None or not hasattr(os, 'sched_setaffinity'):
        return False
    try:
        os.sched_setaffinity(0, {int(core)})
        return True
    except (OSError, ValueError):
        return False


class _PendingTable:
    """Futures owned by a caller loop, awaiting completion posted from
    the shard side. Thread-safe; ``fail_all`` is the no-deadlock
    guarantee on shard death."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next = 0
        self._entries: dict[int, tuple] = {}

    def add(self, caller_loop, fut) -> int:
        with self._lock:
            self._next += 1
            rid = self._next
            self._entries[rid] = (caller_loop, fut)
        return rid

    def _pop(self, rid):
        with self._lock:
            return self._entries.pop(rid, None)

    def post_result(self, rid, value) -> None:
        ent = self._pop(rid)
        if ent is None:
            return
        loop, fut = ent

        def done():
            if not fut.done():
                fut.set_result(value)
        loop.call_soon_threadsafe(done)

    def post_error(self, rid, exc) -> None:
        ent = self._pop(rid)
        if ent is None:
            return
        loop, fut = ent

        def done():
            if not fut.done():
                fut.set_exception(exc)
        loop.call_soon_threadsafe(done)

    def fail_all(self, exc_factory) -> None:
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
        for loop, fut in entries:
            def done(fut=fut):
                if not fut.done():
                    fut.set_exception(exc_factory())
            try:
                loop.call_soon_threadsafe(done)
            except RuntimeError:
                pass


class ShardWorker:
    """Common surface; see module docstring for the backend contract."""

    backend = 'abstract'

    def __init__(self, shard_id: int, router_loop, affinity=None):
        self.sw_id = int(shard_id)
        self.sw_router_loop = router_loop
        self.sw_affinity = affinity
        self.sw_pending = _PendingTable()
        self.loop = None

    # Backend hooks -------------------------------------------------------

    def launch(self, on_ready, on_error) -> None:
        raise NotImplementedError

    def request_stop(self) -> None:
        raise NotImplementedError

    def alive(self) -> bool:
        raise NotImplementedError

    def is_stopped(self) -> bool:
        raise NotImplementedError

    def _dead_error(self, detail=''):
        return ShardDeadError(self.sw_id, detail)

    async def run(self, job, *args, **kwargs):
        raise NotImplementedError


class InlineWorker(ShardWorker):
    """Shard sharing the caller's loop (netsim / zero-thread mode)."""

    backend = 'inline'

    def __init__(self, shard_id, router_loop, affinity=None):
        super().__init__(shard_id, router_loop, affinity)
        self.loop = router_loop
        self._stopped = False

    def launch(self, on_ready, on_error) -> None:
        self._stopped = False
        # Defer readiness one tick so the FSM finishes entering
        # 'starting' before the 'ready' event lands.
        self.loop.call_soon(on_ready)

    def request_stop(self) -> None:
        self._stopped = True

    def alive(self) -> bool:
        return not self._stopped

    def is_stopped(self) -> bool:
        return self._stopped

    async def run(self, job, *args, **kwargs):
        if self._stopped:
            raise self._dead_error('inline shard stopped')
        res = resolve_job(job)(*args, **kwargs)
        if asyncio.iscoroutine(res):
            res = await res
        return res

    def post(self, fn, *args) -> None:
        """Fire-and-forget on the shard loop (same loop here)."""
        if self._stopped:
            raise self._dead_error('inline shard stopped')
        fn(*args)


class ThreadWorker(ShardWorker):
    """Daemon thread running a private asyncio loop. Relaunchable: a
    restart after failure builds a fresh thread and loop."""

    backend = 'thread'

    def __init__(self, shard_id, router_loop, affinity=None):
        super().__init__(shard_id, router_loop, affinity)
        self._thread = None
        self._loop_exited = True

    def launch(self, on_ready, on_error) -> None:
        self._loop_exited = False
        self._thread = threading.Thread(
            target=self._main, args=(on_ready, on_error),
            name='cueball-shard-%d' % self.sw_id, daemon=True)
        self._thread.start()

    def _main(self, on_ready, on_error) -> None:
        _try_set_affinity(self.sw_affinity)
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self.loop = loop
        from .. import trace as mod_trace
        mod_trace.set_shard_id(self.sw_id)
        loop.call_soon(self.sw_router_loop.call_soon_threadsafe, on_ready)
        try:
            loop.run_forever()
        except BaseException as exc:  # loop machinery itself blew up
            try:
                self.sw_router_loop.call_soon_threadsafe(on_error, exc)
            except RuntimeError:
                pass
        finally:
            self._loop_exited = True
            try:
                loop.close()
            except RuntimeError:
                pass
            # Anything still awaiting this shard must fail fast, not
            # hang on a loop that will never pump again.
            self.sw_pending.fail_all(
                lambda: self._dead_error('loop exited'))
            mod_trace.set_shard_id(None)

    def request_stop(self) -> None:
        loop = self.loop
        if loop is None or self._loop_exited:
            return
        try:
            loop.call_soon_threadsafe(loop.stop)
        except RuntimeError:
            pass

    def alive(self) -> bool:
        return (self._thread is not None and self._thread.is_alive()
                and not self._loop_exited)

    def is_stopped(self) -> bool:
        return self._thread is None or not self._thread.is_alive()

    async def run(self, job, *args, **kwargs):
        """Run a job on the shard loop; awaitable from the caller's
        loop. Coroutine results are awaited in the shard."""
        if not self.alive():
            raise self._dead_error('worker thread not running')
        caller_loop = asyncio.get_running_loop()
        fut = caller_loop.create_future()
        rid = self.sw_pending.add(caller_loop, fut)
        fn = resolve_job(job)
        pending = self.sw_pending

        def invoke():
            try:
                res = fn(*args, **kwargs)
            except BaseException as exc:
                pending.post_error(rid, exc)
                return
            if asyncio.iscoroutine(res):
                task = asyncio.ensure_future(res)

                def finished(task):
                    if task.cancelled():
                        pending.post_error(
                            rid, self._dead_error('job cancelled'))
                    elif task.exception() is not None:
                        pending.post_error(rid, task.exception())
                    else:
                        pending.post_result(rid, task.result())
                task.add_done_callback(finished)
            else:
                pending.post_result(rid, res)

        try:
            self.loop.call_soon_threadsafe(invoke)
        except RuntimeError as exc:
            self.sw_pending.post_error(rid, self._dead_error('loop closed'))
            raise self._dead_error('loop closed') from exc
        return await fut

    def post(self, fn, *args) -> None:
        if not self.alive():
            raise self._dead_error('worker thread not running')
        try:
            self.loop.call_soon_threadsafe(fn, *args)
        except RuntimeError as exc:
            raise self._dead_error('loop closed') from exc


class ShardFSM(FSM):
    """Lifecycle of one worker shard, driven on the router's loop.

    ::

        init -> starting -> running -> draining -> stopped
                   |           |          |
                   v           v          v
                 failed <---(loop died / drain timeout)
                   |
                   +--> starting (restart) / draining (stop)

    The worker signals readiness and errors via
    ``call_soon_threadsafe`` onto the router loop; every listener here
    is state-gated, so late signals from a superseded launch are
    no-ops.
    """

    def __init__(self, worker: ShardWorker):
        self.sf_worker = worker
        self.sf_last_error = None
        super().__init__('init')

    # External API (router-side) -----------------------------------------

    def start(self) -> None:
        self.emit('startAsserted')

    def stop(self) -> None:
        self.emit('stopAsserted')

    # States --------------------------------------------------------------

    def state_init(self, S):
        S.validTransitions(['starting'])
        S.gotoStateOn(self, 'startAsserted', 'starting')

    def state_starting(self, S):
        S.validTransitions(['running', 'failed'])
        S.gotoStateOn(self, 'ready', 'running')
        S.gotoStateOn(self, 'launchError', 'failed')
        S.gotoStateTimeout(START_TIMEOUT_MS, 'failed')

        def on_error(exc=None):
            self.sf_last_error = exc
            self.emit('launchError')
        self.sf_worker.launch(S.callback(lambda: self.emit('ready')),
                              S.callback(on_error))

    def state_running(self, S):
        S.validTransitions(['draining', 'failed'])
        S.gotoStateOn(self, 'stopAsserted', 'draining')
        S.gotoStateOn(self, 'workerDied', 'failed')

        def watchdog():
            if not self.sf_worker.alive():
                self.sf_last_error = self.sf_worker._dead_error(
                    'watchdog: loop exited while running')
                self.emit('workerDied')
        S.interval(WATCHDOG_MS, watchdog)

    def state_draining(self, S):
        S.validTransitions(['stopped', 'failed'])
        S.gotoStateOn(self, 'drained', 'stopped')
        S.gotoStateTimeout(DRAIN_TIMEOUT_MS, 'failed')
        self.sf_worker.request_stop()

        def check():
            if self.sf_worker.is_stopped():
                self.emit('drained')
        S.immediate(check)
        S.interval(DRAIN_POLL_MS, check)

    def state_failed(self, S):
        S.validTransitions(['starting', 'draining'])
        # A failed shard can be relaunched (the router then rebuilds
        # the pools it owned) or drained as part of router stop.
        S.gotoStateOn(self, 'startAsserted', 'starting')
        S.gotoStateOn(self, 'stopAsserted', 'draining')

    def state_stopped(self, S):
        S.validTransitions([])
