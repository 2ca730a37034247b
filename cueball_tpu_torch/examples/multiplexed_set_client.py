"""Multiplexed-protocol fleet client built on ConnectionSet.

Where ConnectionPool hands out exclusive leases (HTTP/1.x-style
protocols), ConnectionSet is for protocols that interleave many
in-flight requests on one connection per backend (HTTP/2, custom RPC):
it keeps at most one connection per backend, advertises them via
'added'(key, conn, handle) and asks for them back via 'removed' —
the consumer drains in-flight work, then calls handle.release()
(reference lib/set.js; SURVEY.md §2.1 ConnectionSet).

This example is self-contained: it starts three tiny JSON-line RPC
servers on localhost, runs a mux client over a ConnectionSet, spreads
concurrent requests across every advertised connection, then kills one
server to show the set re-routing and the drain contract in action.

    python -m cueball_tpu_torch.examples.multiplexed_set_client

The port's copy of the JAX package's ``examples/multiplexed_set_client.py``
on the port's own ``ConnectionSet``.
"""

import asyncio
import itertools
import json

from ..cset import ConnectionSet
from ..events import EventEmitter
from ..resolver import StaticIpResolver


# ---------------------------------------------------------------------------
# A connection that multiplexes: requests are JSON lines tagged with an
# id; responses may come back in any order.

class MuxConnection(EventEmitter):
    def __init__(self, backend):
        super().__init__()
        self.backend = backend
        self._ids = itertools.count()
        self._pending = {}
        self._writer = None
        self._task = asyncio.ensure_future(self._run())

    async def _run(self):
        try:
            reader, self._writer = await asyncio.open_connection(
                self.backend['address'], self.backend['port'])
        except OSError as e:
            self.emit('error', e)
            return
        self.emit('connect')
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                msg = json.loads(line)
                fut = self._pending.pop(msg['id'], None)
                if fut is not None and not fut.done():
                    fut.set_result(msg['result'])
        except OSError:
            pass
        for fut in list(self._pending.values()):
            if not fut.done():
                fut.set_exception(ConnectionResetError(
                    'backend %s went away' % self.backend['address']))
        self._pending.clear()
        self.emit('close')

    def call(self, method, params):
        """Issue one multiplexed request; returns a future."""
        if self._task.done() or self._writer is None or \
                self._writer.is_closing():
            raise ConnectionResetError(
                'backend %s went away' % self.backend['address'])
        rid = next(self._ids)
        fut = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        # A cancelled waiter (e.g. wait_for timeout) must not linger as
        # in-flight — the drain contract spins on in_flight reaching 0.
        fut.add_done_callback(lambda f: self._pending.pop(rid, None))
        self._writer.write(json.dumps(
            {'id': rid, 'method': method, 'params': params}
        ).encode() + b'\n')
        return fut

    @property
    def in_flight(self):
        return len(self._pending)

    def destroy(self):
        self._task.cancel()
        if self._writer is not None:
            self._writer.close()

    def unref(self):
        pass

    def ref(self):
        pass


# ---------------------------------------------------------------------------
# The consumer side of the Set contract: track advertised connections,
# round-robin requests over them, drain on 'removed'.

class MuxClient:
    def __init__(self, resolver, target=3, maximum=4):
        self._conns = {}        # key -> (conn, handle)
        self._rr = itertools.cycle([])
        self._drains = set()    # the drain tasks still running
        self.cset = ConnectionSet({
            'constructor': MuxConnection,
            'resolver': resolver,
            'target': target,
            'maximum': maximum,
            'recovery': {'default': {'timeout': 1000, 'retries': 3,
                                     'delay': 100, 'maxDelay': 1000}},
        })
        self.cset.on('added', self._on_added)
        self.cset.on('removed', self._on_removed)

    def _on_added(self, key, conn, handle):
        self._conns[key] = (conn, handle)
        self._rr = itertools.cycle(list(self._conns.items()))
        print('  [set] added    %s -> %s:%d' % (
            key[:12], conn.backend['address'], conn.backend['port']))

    def _on_removed(self, key, conn, handle):
        # Drain contract: stop routing new work to it, wait for
        # in-flight requests, then hand the connection back.
        self._conns.pop(key, None)
        self._rr = itertools.cycle(list(self._conns.items()))
        print('  [set] removed  %s (%d in flight)' % (
            key[:12], conn.in_flight))

        async def drain():
            while conn.in_flight > 0:
                await asyncio.sleep(0.01)
            handle.release()
        task = asyncio.ensure_future(drain())
        self._drains.add(task)
        task.add_done_callback(self._drains.discard)

    async def call(self, method, params, timeout=2.0):
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            while not self._conns:
                if asyncio.get_running_loop().time() > deadline:
                    raise TimeoutError('no backends available')
                await asyncio.sleep(0.01)
            key, (conn, _h) = next(self._rr)
            try:
                fut = conn.call(method, params)
            except ConnectionResetError:
                # Raced a dying connection before its 'removed' event
                # was delivered; drop it locally and retry another.
                self._conns.pop(key, None)
                self._rr = itertools.cycle(list(self._conns.items()))
                continue
            remaining = deadline - asyncio.get_running_loop().time()
            return await asyncio.wait_for(fut, max(remaining, 0.001))

    async def stop(self):
        self.cset.stop()
        while not self.cset.is_in_state('stopped'):
            await asyncio.sleep(0.01)


# ---------------------------------------------------------------------------
# Demo fleet: three servers that square numbers.

class DemoServer:
    def __init__(self):
        self.port = None   # assigned by the OS at start()
        self.server = None
        self.writers = set()

    async def start(self):
        async def handler(reader, writer):
            self.writers.add(writer)
            try:
                while True:
                    line = await reader.readline()
                    if not line:
                        break
                    msg = json.loads(line)
                    writer.write(json.dumps(
                        {'id': msg['id'],
                         'result': {'value': msg['params']['x'] ** 2,
                                    'port': self.port}}).encode() + b'\n')
            except OSError:
                pass
            finally:
                self.writers.discard(writer)
                writer.close()
        self.server = await asyncio.start_server(handler, '127.0.0.1', 0)
        self.port = self.server.sockets[0].getsockname()[1]
        return self

    async def kill(self):
        """Stop listening AND sever live connections (a crashed box,
        not a graceful drain)."""
        self.server.close()
        for w in list(self.writers):
            w.transport.abort()
        await self.server.wait_closed()


async def main():
    servers = {}
    for _ in range(3):
        s = await DemoServer().start()
        servers[s.port] = s
    ports = list(servers)
    print('servers up on %s' % ports)

    resolver = StaticIpResolver({
        'backends': [{'address': '127.0.0.1', 'port': p} for p in ports],
    })
    client = MuxClient(resolver, target=3, maximum=4)
    resolver.start()

    # Concurrent multiplexed calls — far more in flight than there are
    # connections; they interleave on the per-backend links.
    results = await asyncio.gather(
        *[client.call('square', {'x': i}) for i in range(60)])
    by_port = {}
    for r in results:
        by_port[r['port']] = by_port.get(r['port'], 0) + 1
    print('60 calls spread over backends: %s' % by_port)

    # Kill one backend: its connection errors, the set re-routes.
    dead = ports[0]
    await servers[dead].kill()
    print('killed server on %d' % dead)
    await asyncio.sleep(0.5)

    results = await asyncio.gather(
        *[client.call('square', {'x': i}) for i in range(30)],
        return_exceptions=True)
    ok = [r for r in results if isinstance(r, dict)]
    print('%d/30 calls served by the surviving backends: %s' % (
        len(ok), sorted({r['port'] for r in ok})))

    await client.stop()
    resolver.stop()
    for p, s in servers.items():
        if p != dead:
            await s.kill()
    print('clean shutdown')


if __name__ == '__main__':
    asyncio.run(main())
