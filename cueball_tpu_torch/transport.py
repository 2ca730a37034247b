"""The byte-moving seam: every real socket the framework touches.

Before this module, raw asyncio socket plumbing was scattered across
five call sites — the DNS wire client opened datagram endpoints and
TCP streams itself (dns_client.py), the HTTP agent called
``loop.create_connection`` and set keep-alive sockopts (agent.py), the
kang debug server called ``asyncio.start_server`` (http_server.py),
the pool monitor read the host ident straight off the socket module
(monitor.py), and netsim substituted each seam ad hoc. Following the
policy/data-path separation of "An Extensible Software Transport
Layer for GPU Networking" (PAPERS.md), the protocol decisions stay
where they were (sans-io cores: ``dns_client.DnsQueryCore``, the FSM
engines, the HTTP parsers) and everything that actually moves bytes
lands here, behind one ``Transport`` interface:

- :class:`AsyncioTransport` — the default; today's behavior, and the
  ONE place in the package (outside ``netsim/``) allowed to import
  ``socket`` or touch loop socket APIs (``make check`` enforces this
  via the cblint C110 layering rule).
- :class:`FabricTransport` — netsim's virtual data plane as a
  transport: the pool constructor seam is ``fabric.constructor``, the
  DNS seam is a ``SimWire``; no real socket exists anywhere.
- :class:`NativeTransport` — a stub. In the JAX package it is the
  plug-in surface of the ``native/`` C transport, which is not part of
  this package yet, so it is registered but refuses:
  ``get_transport('native')`` raises
  :class:`TransportNotAvailableError`, as does every seam.

Pool/FSM semantics do not live here and do not move: a transport
supplies connections, streams, servers and DNS byte exchanges; who
claims what, when, is the pool's business. See docs/transport.md.
"""

from __future__ import annotations

import asyncio
import socket as mod_socket
import struct

from . import utils as mod_utils
from . import wiretap as mod_wiretap
from .errors import TransportNotAvailableError
from .events import EventEmitter

#: The five seam method names, in wiretap display order. This tuple
#: and wiretap.SEAMS are the same contract stated twice — cbflow rule
#: A006 (make check) fails if they drift from each other or from the
#: Transport class's actual method set.
SEAM_METHODS = ('connector', 'create_stream', 'serve', 'dns_udp',
                'dns_tcp')


class Transport:
    """Abstract byte-mover. Subclasses implement the five seams:

    - ``connector(backend)`` — the pool/cset ``options['constructor']``
      fallback: build one connection-contract object (emits
      'connect'/'error'/'close', has destroy/ref/unref) for a backend.
    - ``create_stream(...)`` — one outbound stream (the HTTP agent's
      socket seam); returns ``(transport, protocol)``.
    - ``serve(...)`` — one listening server (the kang debug endpoint).
    - ``dns_udp`` / ``dns_tcp`` — one DNS byte exchange: payload out,
      raw response bytes back (the sans-io ``DnsQueryCore`` decides
      what the bytes mean).
    - ``host_ident()`` — the identity stamped on kang snapshots.
    """

    name = 'abstract'
    #: False on registered-but-stubbed backends (the native stub):
    #: get_transport refuses them at resolution time with
    #: TransportNotAvailableError instead of letting the first I/O
    #: blow up deep inside a pool.
    available = True

    # -- pool constructor seam -------------------------------------------

    def connector(self, backend: dict):
        raise NotImplementedError(
            '%s does not supply pool connections' % type(self).__name__)

    # -- stream seam ------------------------------------------------------

    async def create_stream(self, protocol_factory, host, port,
                            ssl=None, server_hostname=None):
        raise NotImplementedError(
            '%s does not open streams' % type(self).__name__)

    def configure_keepalive(self, stream_transport,
                            delay_ms: float | None = None) -> int | None:
        """Enable TCP keep-alive on an established stream; returns the
        local port when one exists (None on non-socket transports)."""
        return None

    # -- server seam ------------------------------------------------------

    async def serve(self, client_connected_cb, host, port):
        raise NotImplementedError(
            '%s does not listen' % type(self).__name__)

    # -- DNS wire seam ----------------------------------------------------

    async def dns_udp(self, resolver: str, port: int, payload: bytes,
                      timeout_s: float) -> bytes:
        raise NotImplementedError(
            '%s does not move DNS datagrams' % type(self).__name__)

    async def dns_tcp(self, resolver: str, port: int, payload: bytes,
                      timeout_s: float) -> bytes:
        raise NotImplementedError(
            '%s does not move DNS streams' % type(self).__name__)

    # -- identity ---------------------------------------------------------

    def host_ident(self) -> str:
        return mod_socket.gethostname()


class WatchedStreamProtocol(asyncio.StreamReaderProtocol):
    """StreamReaderProtocol that reports connection loss to an owner
    even while the stream sits idle in a pool. Node's net.Socket emits
    'close' on FIN regardless of reads; plain asyncio streams only
    surface EOF at the next read, which would leave dead idle
    connections undetected until claimed. The owner implements
    ``_on_connection_lost(exc)``."""

    def __init__(self, reader, owner, loop):
        super().__init__(reader, loop=loop)
        self._owner = owner
        # Wire-ledger hooks: connection_made stamps the kernel
        # readiness time (the wiretap socket_wait decomposition reads
        # it as the kernel_wait/loop_dispatch boundary); _wt_stats is
        # a SeamStats fed per data_received, or None when wiretap is
        # off (one attribute load + None check per read).
        self._wt_stats = None
        self._wt_ready = None

    def connection_made(self, transport):
        self._wt_ready = mod_utils.current_millis()
        super().connection_made(transport)

    def data_received(self, data):
        st = self._wt_stats
        if st is not None:
            st.reads += 1
            st.bytes_in += len(data)
        super().data_received(data)

    def eof_received(self):
        super().eof_received()
        # Close on FIN rather than lingering half-open (node's
        # allowHalfOpen=false default) so connection_lost fires and
        # the pool learns the backend hung up.
        return False

    def connection_lost(self, exc):
        super().connection_lost(exc)
        self._owner._on_connection_lost(exc)


class TcpStreamConnection(EventEmitter):
    """Connection-contract object over a transport stream: the default
    ``AsyncioTransport.connector`` product, and the real-socket twin
    of netsim's SimConnection (the parity soaks run one pool on each).
    Emits 'connect' once the stream is up, 'error'/'close' on loss;
    ``reader``/``writer`` are live after 'connect'."""

    def __init__(self, transport: Transport, backend: dict):
        super().__init__()
        self.transport = transport
        self.backend = backend
        self.reader: asyncio.StreamReader | None = None
        self.writer: asyncio.StreamWriter | None = None
        self.destroyed = False
        # (kernel-ready, dispatched) wire marks for the wiretap
        # socket_wait decomposition; stamped by _connect. wt_transport
        # is the ledger label connection_fsm uses for wire records.
        self.wt_marks = None
        self.wt_transport = transport.name
        self._task = asyncio.ensure_future(self._connect())

    def _on_connection_lost(self, exc):
        if self.destroyed:
            return
        if exc is not None:
            self.emit('error', exc)
        else:
            self.emit('close')

    async def _connect(self):
        try:
            loop = asyncio.get_running_loop()
            reader = asyncio.StreamReader(loop=loop)
            # Pool connects account to the 'connector' seam, so route
            # around the instrumented create_stream wrapper when the
            # transport has the raw opener (otherwise every pool
            # connect would double-count as a create_stream event).
            st = mod_wiretap.seam_stats(self.transport.name,
                                        'connector')
            opener = getattr(self.transport, '_open_stream', None)
            if opener is None:
                opener = self.transport.create_stream

            def factory():
                proto = WatchedStreamProtocol(reader, self, loop)
                proto._wt_stats = st
                return proto

            stream, protocol = await opener(
                factory, self.backend['address'], self.backend['port'])
            ready = getattr(protocol, '_wt_ready', None)
            if ready is not None:
                self.wt_marks = (ready, mod_utils.current_millis())
            self.reader = reader
            self.writer = asyncio.StreamWriter(
                stream, protocol, reader, loop)
            if st is not None:
                mod_wiretap.instrument_writer(st, self.writer)
            self.emit('connect')
        except OSError as e:
            # No direct error count here: the connector seam's watch()
            # listeners count the 'error' emit (same path netsim's
            # SimConnection takes), keeping the two backends' ledgers
            # comparable.
            self.emit('error', e)
        except asyncio.CancelledError:
            pass

    def destroy(self):
        self.destroyed = True
        if self.writer is not None:
            self.writer.close()
        elif not self._task.done():
            self._task.cancel()

    def ref(self):
        pass

    def unref(self):
        pass


class _UdpQuery(asyncio.DatagramProtocol):
    """One-shot DNS datagram exchange. Datagrams whose transaction ID
    doesn't match the query are dropped: qid randomization is the
    anti-spoofing entropy and is useless unless checked on receive."""

    def __init__(self, fut: asyncio.Future, qid: int):
        self.fut = fut
        self.qid = qid

    def datagram_received(self, data, addr):
        if len(data) < 2 or \
                struct.unpack('>H', data[:2])[0] != self.qid:
            return
        if not self.fut.done():
            self.fut.set_result(data)

    def error_received(self, exc):
        if not self.fut.done():
            self.fut.set_exception(exc)


class AsyncioTransport(Transport):
    """The default transport: real sockets on the running asyncio
    loop. All raw plumbing formerly inlined in dns_client.query_udp /
    query_tcp, agent.HttpSocket._connect and http_server.serve_monitor
    lives here now."""

    name = 'asyncio'

    def connector(self, backend: dict) -> TcpStreamConnection:
        conn = TcpStreamConnection(self, backend)
        st = mod_wiretap.seam_stats(self.name, 'connector')
        if st is not None:
            st.events += 1
            mod_wiretap.watch(st, conn)
        return conn

    async def create_stream(self, protocol_factory, host, port,
                            ssl=None, server_hostname=None):
        st = mod_wiretap.seam_stats(self.name, 'create_stream')
        if st is not None:
            st.events += 1
        try:
            result = await self._open_stream(
                protocol_factory, host, port, ssl=ssl,
                server_hostname=server_hostname)
        except OSError:
            if st is not None:
                st.errors += 1
            raise
        if st is not None:
            st.connects += 1
        return result

    async def _open_stream(self, protocol_factory, host, port,
                           ssl=None, server_hostname=None):
        """The raw opener behind create_stream: same signature, no
        wiretap accounting (the connector seam uses it so pool
        connects land in their own ledger row)."""
        loop = asyncio.get_running_loop()
        kwargs = {}
        if ssl is not None:
            kwargs['ssl'] = ssl
            kwargs['server_hostname'] = server_hostname
        return await loop.create_connection(
            protocol_factory, host, port, **kwargs)

    def configure_keepalive(self, stream_transport,
                            delay_ms: float | None = None) -> int | None:
        sock = stream_transport.get_extra_info('socket')
        if sock is None:
            return None
        # Keep-alive is always on (reference lib/agent.js:52,188-191);
        # the optional delay maps to TCP_KEEPIDLE.
        sock.setsockopt(mod_socket.SOL_SOCKET,
                        mod_socket.SO_KEEPALIVE, 1)
        if delay_ms is not None and hasattr(mod_socket, 'TCP_KEEPIDLE'):
            sock.setsockopt(mod_socket.IPPROTO_TCP,
                            mod_socket.TCP_KEEPIDLE,
                            max(1, int(delay_ms / 1000)))
        return sock.getsockname()[1]

    async def serve(self, client_connected_cb, host, port):
        st = mod_wiretap.seam_stats(self.name, 'serve')
        if st is not None:
            st.events += 1
            inner_cb = client_connected_cb

            def client_connected_cb(reader, writer):
                st.connects += 1
                return inner_cb(reader, writer)

        return await asyncio.start_server(
            client_connected_cb, host, port)

    async def dns_udp(self, resolver: str, port: int, payload: bytes,
                      timeout_s: float) -> bytes:
        st = mod_wiretap.seam_stats(self.name, 'dns_udp')
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        qid = struct.unpack('>H', payload[:2])[0]
        stream, _ = await loop.create_datagram_endpoint(
            lambda: _UdpQuery(fut, qid), remote_addr=(resolver, port))
        if st is not None:
            st.events += 1
            st.writes += 1
            st.bytes_out += len(payload)
        try:
            stream.sendto(payload)
            data = await asyncio.wait_for(fut, timeout_s)
        except Exception:
            if st is not None:
                st.errors += 1
            raise
        finally:
            stream.close()
        if st is not None:
            st.reads += 1
            st.bytes_in += len(data)
        return data

    async def dns_tcp(self, resolver: str, port: int, payload: bytes,
                      timeout_s: float) -> bytes:
        st = mod_wiretap.seam_stats(self.name, 'dns_tcp')
        if st is not None:
            st.events += 1
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(resolver, port), timeout_s)
        except Exception:
            if st is not None:
                st.errors += 1
            raise
        if st is not None:
            st.connects += 1
        try:
            writer.write(struct.pack('>H', len(payload)) + payload)
            await writer.drain()
            if st is not None:
                st.writes += 1
                st.bytes_out += len(payload) + 2
            ln = struct.unpack('>H', await asyncio.wait_for(
                reader.readexactly(2), timeout_s))[0]
            body = await asyncio.wait_for(
                reader.readexactly(ln), timeout_s)
            if st is not None:
                st.reads += 2
                st.bytes_in += ln + 2
            return body
        except Exception:
            if st is not None:
                st.errors += 1
            raise
        finally:
            writer.close()


class FabricTransport(Transport):
    """netsim's virtual data plane as a transport. ``fabric`` is a
    ``netsim.Fabric`` (duck-typed — this module never
    imports netsim); ``wire`` is an optional ``SimWire``-shaped DNS
    byte mover. No real socket exists anywhere: connections are
    SimConnections on virtual timers, so the same pool workload runs
    byte-identically from a seed."""

    name = 'fabric'

    def __init__(self, fabric, wire=None, ident: str = 'netsim'):
        self.fabric = fabric
        self.wire = wire
        self._ident = ident

    def connector(self, backend: dict):
        conn = self.fabric.constructor(backend)
        st = mod_wiretap.seam_stats(self.name, 'connector')
        if st is not None:
            st.events += 1
            mod_wiretap.watch(st, conn)
        return conn

    async def dns_udp(self, resolver: str, port: int, payload: bytes,
                      timeout_s: float) -> bytes:
        if self.wire is None:
            raise NotImplementedError(
                'FabricTransport has no SimWire attached')
        st = mod_wiretap.seam_stats(self.name, 'dns_udp')
        if st is not None:
            st.events += 1
            st.writes += 1
            st.bytes_out += len(payload)
        try:
            data = await self.wire.udp(resolver, port, payload,
                                       timeout_s)
        except Exception:
            if st is not None:
                st.errors += 1
            raise
        if st is not None:
            st.reads += 1
            st.bytes_in += len(data)
        return data

    async def dns_tcp(self, resolver: str, port: int, payload: bytes,
                      timeout_s: float) -> bytes:
        if self.wire is None:
            raise NotImplementedError(
                'FabricTransport has no SimWire attached')
        st = mod_wiretap.seam_stats(self.name, 'dns_tcp')
        if st is not None:
            st.events += 1
        try:
            data = await self.wire.tcp(resolver, port, payload,
                                       timeout_s)
        except Exception:
            if st is not None:
                st.errors += 1
            raise
        if st is not None:
            # Mirror the asyncio seam's syscall-equivalent shape: one
            # framed write out, length-prefix + body reads back.
            st.connects += 1
            st.writes += 1
            st.bytes_out += len(payload) + 2
            st.reads += 2
            st.bytes_in += len(data) + 2
        return data

    def host_ident(self) -> str:
        return self._ident


class NativeTransport(Transport):
    """The plug-in surface for the C data path, which this package does
    not have yet: a registered-but-stubbed backend so the dispatch
    plumbing, the registry name and the wiretap conformance counters
    (trace.WIRE_EVENT_CODES) exist without it. Every seam raises a typed
    :class:`TransportNotAvailableError` carrying the seam name, and
    ``available = False`` makes ``get_transport('native')`` refuse at
    resolution time rather than at first I/O; a real native module
    replaces this via :func:`register_transport`."""

    name = 'native'
    available = False

    def _unavailable(self, seam: str):
        raise TransportNotAvailableError(seam, transport=self.name)

    def connector(self, backend: dict):
        self._unavailable('connector')

    async def create_stream(self, protocol_factory, host, port,
                            ssl=None, server_hostname=None):
        self._unavailable('create_stream')

    async def serve(self, client_connected_cb, host, port):
        self._unavailable('serve')

    async def dns_udp(self, resolver: str, port: int, payload: bytes,
                      timeout_s: float) -> bytes:
        self._unavailable('dns_udp')

    async def dns_tcp(self, resolver: str, port: int, payload: bytes,
                      timeout_s: float) -> bytes:
        self._unavailable('dns_tcp')


# -- registry ---------------------------------------------------------------

_REGISTRY: dict = {'asyncio': AsyncioTransport, 'native': NativeTransport}
_default: Transport | None = None


def register_transport(name: str, factory) -> None:
    """Register a transport factory (a zero-arg callable returning a
    Transport) under ``name`` for ``get_transport(name)`` / the pool's
    ``options['transport']`` string form."""
    _REGISTRY[name] = factory


def get_transport(spec=None) -> Transport:
    """Resolve a transport: None -> the process-default
    AsyncioTransport singleton, a string -> the registry, a Transport
    instance -> itself."""
    global _default
    if spec is None:
        if _default is None:
            _default = AsyncioTransport()
        return _default
    if isinstance(spec, str):
        factory = _REGISTRY.get(spec)
        if factory is None:
            raise ValueError('unknown transport %r (registered: %s)' % (
                spec, ', '.join(sorted(_REGISTRY))))
        t = factory()
        if not getattr(t, 'available', True):
            # Fail at resolution time, not first I/O: a pool handed a
            # stub transport would otherwise come up healthy and die
            # on its first connect.
            raise TransportNotAvailableError('resolve',
                                             transport=t.name)
        return t
    if isinstance(spec, Transport):
        return spec
    raise TypeError('transport must be None, a name or a Transport, '
                    'got %r' % (spec,))


def host_ident() -> str:
    """The default transport's host identity (what monitor.py stamps
    on kang snapshots instead of touching the socket module)."""
    return get_transport().host_ident()


__all__ = ['Transport', 'AsyncioTransport', 'FabricTransport',
           'NativeTransport', 'TcpStreamConnection',
           'WatchedStreamProtocol', 'TransportNotAvailableError',
           'SEAM_METHODS', 'register_transport',
           'get_transport', 'host_ident']
