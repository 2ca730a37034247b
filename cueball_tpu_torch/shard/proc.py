"""Spawn-process shard backend: the only one that escapes the GIL; this
package's copy of the JAX package's ``shard.proc``.

The child (``_child_main``) pins its core, stamps its shard id into
the trace TLS, and runs a private asyncio loop forever; a daemon
reader thread receives ``('call', rid, spec, args, kwargs)`` messages
and schedules them onto the loop, so pool timers stay live between
jobs. Jobs are ``'module:function'`` spec strings (closures don't
pickle) called as ``fn(ctx, *args)`` where ``ctx`` is the child's
context dict (``shard``/``loop``/``pools``/``state``); coroutine
results are awaited on the child loop. Each child owns a genuinely
separate trace ring and metric collector — the router merges them at
export time (``_export_traces``), never on the hot path.

A child imports this package, and so ``torch``, but never touches a
CUDA device and builds no kernel: the router refuses its fleet passes
on this backend, so no sampler runs in a child.
"""

from __future__ import annotations

import asyncio
import multiprocessing
import os
import threading

from ..errors import CueBallError
from .worker import ShardWorker, _try_set_affinity, resolve_job


def _child_main(conn, shard_id: int, affinity) -> None:
    _try_set_affinity(affinity)
    from .. import trace as mod_trace
    mod_trace.set_shard_id(shard_id)
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    ctx = {'shard': shard_id, 'loop': loop, 'pools': {}, 'state': {}}
    send_lock = threading.Lock()

    def send(msg):
        with send_lock:
            try:
                conn.send(msg)
            except (OSError, ValueError, BrokenPipeError):
                pass

    def fail(rid, exc):
        send(('err', rid, '%s: %s' % (type(exc).__name__, exc)))

    def dispatch(msg):
        _kind, rid, spec, args, kwargs = msg
        try:
            res = resolve_job(spec)(ctx, *args, **(kwargs or {}))
        except BaseException as exc:
            fail(rid, exc)
            return
        if asyncio.iscoroutine(res):
            task = asyncio.ensure_future(res)

            def finished(task):
                if task.cancelled():
                    send(('err', rid, 'CancelledError: job cancelled'))
                elif task.exception() is not None:
                    fail(rid, task.exception())
                else:
                    send(('ok', rid, task.result()))
            task.add_done_callback(finished)
        else:
            send(('ok', rid, res))

    def reader():
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                loop.call_soon_threadsafe(loop.stop)
                return
            if msg[0] == 'stop':
                send(('ok', msg[1], None))
                loop.call_soon_threadsafe(loop.stop)
                return
            loop.call_soon_threadsafe(dispatch, msg)

    threading.Thread(target=reader, daemon=True).start()
    send(('ready', 0, None))
    try:
        loop.run_forever()
    finally:
        try:
            loop.close()
        except Exception:
            pass
        try:
            conn.close()
        except Exception:
            pass


class ProcWorker(ShardWorker):
    """Parent-side handle on a spawn child. A daemon reader thread
    resolves pending futures from child replies and fails them all
    with ``ShardDeadError`` when the pipe drops."""

    backend = 'spawn'

    def __init__(self, shard_id, router_loop, affinity=None):
        super().__init__(shard_id, router_loop, affinity)
        self._proc = None
        self._conn = None
        self._dead = True

    def launch(self, on_ready, on_error) -> None:
        ctx = multiprocessing.get_context('spawn')
        parent_conn, child_conn = ctx.Pipe()
        self._conn = parent_conn
        self._dead = False
        self._proc = ctx.Process(
            target=_child_main,
            args=(child_conn, self.sw_id, self.sw_affinity),
            name='cueball-shard-%d' % self.sw_id, daemon=True)
        self._proc.start()
        child_conn.close()
        threading.Thread(target=self._read_loop,
                         args=(on_ready, on_error), daemon=True).start()

    def _read_loop(self, on_ready, on_error) -> None:
        conn = self._conn
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                break
            kind, rid, payload = msg
            if kind == 'ready':
                try:
                    self.sw_router_loop.call_soon_threadsafe(on_ready)
                except RuntimeError:
                    pass
            elif kind == 'ok':
                self.sw_pending.post_result(rid, payload)
            else:
                self.sw_pending.post_error(rid, CueBallError(
                    'shard %d job failed: %s' % (self.sw_id, payload)))
        self._dead = True
        self.sw_pending.fail_all(
            lambda: self._dead_error('child process exited'))

    def request_stop(self) -> None:
        if self._conn is None or self._dead:
            return
        try:
            self._conn.send(('stop', 0))
        except (OSError, ValueError, BrokenPipeError):
            pass

    def alive(self) -> bool:
        return (self._proc is not None and self._proc.is_alive()
                and not self._dead)

    def is_stopped(self) -> bool:
        return self._proc is None or not self._proc.is_alive()

    async def run(self, job, *args, **kwargs):
        if not isinstance(job, str):
            raise TypeError(
                'spawn jobs must be "module:function" spec strings')
        if not self.alive():
            raise self._dead_error('child process not running')
        caller_loop = asyncio.get_running_loop()
        fut = caller_loop.create_future()
        rid = self.sw_pending.add(caller_loop, fut)
        try:
            self._conn.send(('call', rid, job, args, kwargs))
        except (OSError, ValueError, BrokenPipeError):
            self.sw_pending.post_error(
                rid, self._dead_error('pipe closed'))
        return await fut


# -- child-side jobs the router/bench dispatch by spec ---------------------

def _ping(ctx):
    return {'shard': ctx['shard'], 'pid': os.getpid(),
            'affinity': (sorted(os.sched_getaffinity(0))
                         if hasattr(os, 'sched_getaffinity') else None)}


def _construct_pool(ctx, name, factory_spec, shard_id):
    obj = resolve_job(factory_spec)()
    pool = obj[0] if isinstance(obj, tuple) else obj
    pool.p_shard = shard_id
    ctx['pools'][name] = pool
    return {'name': name, 'shard': shard_id}


async def _destroy_pool(ctx, name, timeout_s):
    pool = ctx['pools'].pop(name)
    pool.stop()
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout_s
    while not pool.is_in_state('stopped'):
        if loop.time() > deadline:
            raise CueBallError('pool %r did not stop' % name)
        await asyncio.sleep(0.05)
    return None


def _pool_job(ctx, name, spec, args, kwargs):
    pool = ctx['pools'][name]
    return resolve_job(spec)(pool, *args, **(kwargs or {}))


def _export_traces(ctx):
    from .. import trace as mod_trace
    return mod_trace.export_ndjson()
