"""HTTP agent: pooled HTTP(S) client transport.

Rebuild of reference `lib/agent.js`. The reference plugs into Node's
http.Agent contract; the asyncio-native equivalent is an HTTP/1.1 client
whose transport claims connections from a cueball ConnectionPool per
hostname:

- pools are created lazily per host on first request
  (reference lib/agent.js:105-211), or eagerly via ``initialDomains``
- the socket constructor builds TCP or TLS connections with SNI and
  TCP keep-alive (reference lib/agent.js:146-197)
- request lifecycle maps onto the claim handle: response fully read on
  a keep-alive connection -> release; close-delimited response or
  error/cancel -> close (reference lib/agent.js:275-396)
- optional HTTP ping health checks run a GET over idle pooled sockets;
  a 5xx closes the connection, anything else releases it
  (reference lib/agent.js:398-455, PingAgent at lib/agent.js:530-569)

Public surface parity: ``request()`` (the addRequest analogue),
``get_pool``, ``create_pool``, ``stop``, ``is_stopped``
(reference lib/agent.js:275,458,464,213,497).
"""

from __future__ import annotations

import asyncio
import logging
import ssl as mod_ssl

from . import transport as mod_transport
from . import utils as mod_utils
from .events import EventEmitter
from .fsm import get_loop
from .pool import ConnectionPool
from .resolver import pool_resolver
# Back-compat alias: agent grew this protocol before the seam did.
from .transport import WatchedStreamProtocol as _WatchedProtocol

# TLS fields passed through from agent options to the socket constructor
# (reference lib/agent.js:96-97).
PASS_FIELDS = ['certfile', 'keyfile', 'ca', 'ciphers', 'servername',
               'rejectUnauthorized']


class HttpSocket(EventEmitter):
    """Connection-interface object over a transport TCP/TLS stream
    (the constructSocket analogue, reference lib/agent.js:146-197).
    All raw socket work — opening the stream, keep-alive sockopts —
    goes through the Transport seam; this class owns only the HTTP
    agent's connection contract (events, destroy, reader/writer)."""

    def __init__(self, backend: dict, tls: dict | None = None,
                 tcp_keepalive_delay: float | None = None,
                 transport: mod_transport.Transport | None = None):
        super().__init__()
        self.backend = backend
        self.transport = mod_transport.get_transport(transport)
        self.reader: asyncio.StreamReader | None = None
        self.writer: asyncio.StreamWriter | None = None
        self.local_port: int | None = None
        self.tls = tls
        self.tcp_keepalive_delay = tcp_keepalive_delay
        self.destroyed = False
        self._task = asyncio.ensure_future(self._connect())

    def _on_connection_lost(self, exc):
        if self.destroyed:
            return
        if exc is not None:
            self.emit('error', exc)
        else:
            self.emit('close')

    def _ssl_context(self):
        ctx = mod_ssl.create_default_context()
        tls = self.tls or {}
        if tls.get('ca'):
            ctx.load_verify_locations(cadata=tls['ca'])
        if tls.get('certfile'):
            ctx.load_cert_chain(tls['certfile'], tls.get('keyfile'))
        if tls.get('ciphers'):
            ctx.set_ciphers(tls['ciphers'])
        if tls.get('rejectUnauthorized') is False:
            ctx.check_hostname = False
            ctx.verify_mode = mod_ssl.CERT_NONE
        return ctx

    async def _connect(self):
        try:
            loop = asyncio.get_running_loop()
            ssl_ctx = None
            server_hostname = None
            if self.tls is not None:
                ssl_ctx = self._ssl_context()
                # SNI servername override (reference lib/agent.js:158).
                server_hostname = self.tls.get('servername') or \
                    self.backend.get('name') or self.backend['address']
            reader = asyncio.StreamReader(loop=loop)
            stream, protocol = await self.transport.create_stream(
                lambda: _WatchedProtocol(reader, self, loop),
                self.backend['address'], self.backend['port'],
                ssl=ssl_ctx, server_hostname=server_hostname)
            self.reader = reader
            self.writer = asyncio.StreamWriter(
                stream, protocol, reader, loop)
            self.local_port = self.transport.configure_keepalive(
                stream, delay_ms=self.tcp_keepalive_delay)
            self.emit('connect')
        except (OSError, mod_ssl.SSLError) as e:
            self.emit('error', e)
        except asyncio.CancelledError:
            pass

    def destroy(self):
        self.destroyed = True
        if self.writer is not None:
            self.writer.close()
        elif not self._task.done():
            self._task.cancel()

    def unref(self):
        pass

    def ref(self):
        pass


class HttpResponse:
    def __init__(self, status: int, reason: str, headers: dict,
                 body: bytes, raw_headers: list | None = None):
        self.status = status
        self.status_code = status
        self.reason = reason
        self.headers = headers
        # Ordered (name, value) pairs with duplicates preserved
        # (Set-Cookie needs this); the dict above keeps the
        # last-wins convenience view.
        self.raw_headers = raw_headers if raw_headers is not None \
            else list(headers.items())
        self.body = body

    def text(self, encoding='utf-8') -> str:
        return self.body.decode(encoding, 'replace')


async def _read_response(reader: asyncio.StreamReader,
                         method: str) -> tuple[HttpResponse, bool]:
    """Parse one HTTP/1.1 response; returns (response, keep_alive)."""
    status_line = await reader.readline()
    if not status_line:
        raise ConnectionResetError('connection closed before response')
    parts = status_line.decode('latin-1').rstrip('\r\n').split(' ', 2)
    version = parts[0]
    status = int(parts[1])
    reason = parts[2] if len(parts) > 2 else ''

    headers: dict[str, str] = {}
    raw_headers: list[tuple[str, str]] = []
    while True:
        line = await reader.readline()
        if line in (b'\r\n', b'\n', b''):
            break
        k, _, v = line.decode('latin-1').partition(':')
        headers[k.strip().lower()] = v.strip()
        raw_headers.append((k.strip(), v.strip()))

    keep_alive = version != 'HTTP/1.0'
    conn_hdr = headers.get('connection', '').lower()
    if conn_hdr == 'close':
        keep_alive = False
    elif conn_hdr == 'keep-alive':
        keep_alive = True

    body = b''
    if method == 'HEAD' or status in (204, 304) or 100 <= status < 200:
        pass
    elif headers.get('transfer-encoding', '').lower() == 'chunked':
        chunks = []
        while True:
            szline = await reader.readline()
            if not szline.strip():
                # EOF mid-stream is truncation, not a terminator.
                raise ConnectionResetError(
                    'connection closed mid-chunked-response')
            size = int(szline.split(b';')[0].strip(), 16)
            if size == 0:
                # trailers until blank line
                while True:
                    t = await reader.readline()
                    if t in (b'\r\n', b'\n', b''):
                        break
                break
            chunks.append(await reader.readexactly(size))
            await reader.readexactly(2)  # CRLF
        body = b''.join(chunks)
    elif 'content-length' in headers:
        body = await reader.readexactly(int(headers['content-length']))
    else:
        body = await reader.read()
        keep_alive = False

    return HttpResponse(status, reason, headers, body,
                        raw_headers=raw_headers), keep_alive


class CueBallAgent(EventEmitter):
    """Base agent (reference CueBallAgent, lib/agent.js:30-94)."""

    def __init__(self, options: dict, protocol: str):
        super().__init__()
        if not isinstance(options, dict):
            raise AssertionError('options must be a dict')
        default_port = options.get('defaultPort')
        if not isinstance(default_port, int):
            raise AssertionError('options.defaultPort must be a number')
        spares = options.get('spares')
        maximum = options.get('maximum')
        if not isinstance(spares, int) or not isinstance(maximum, int):
            raise AssertionError(
                'options.spares and options.maximum must be numbers')
        recovery = options.get('recovery')
        if not isinstance(recovery, dict):
            raise AssertionError('options.recovery is required')
        mod_utils.assert_recovery(recovery.get('default'),
                                  'recovery.default')

        self.collector = mod_utils.create_error_metrics(options)

        self.default_port = default_port
        self.protocol = protocol + ':'
        self.service = options.get('service') or '_%s._tcp' % protocol
        self.cba_upgraded: set = set()

        self.tcp_ka_delay = options.get('tcpKeepAliveInitialDelay')
        self.cba_transport = mod_transport.get_transport(
            options.get('transport'))
        self.pools: dict[str, ConnectionPool] = {}
        self.pool_resolvers: dict[str, object] = {}
        self.resolvers = options.get('resolvers')
        self.log = mod_utils.make_child_logger(
            options.get('log') or logging.getLogger('cueball.agent'),
            component='CueBallAgent')
        self.cba_stopped = False
        self.maximum = maximum
        self.spares = spares
        self.cba_ping = options.get('ping')
        self.cba_ping_interval = options.get('pingInterval')
        self.cba_recovery = recovery
        self.cba_err_on_empty = options.get('errorOnEmpty')
        self.cba_tls = {f: options[f] for f in PASS_FIELDS
                        if f in options} \
            if protocol == 'https' else None

        for host in (options.get('initialDomains') or []):
            self._add_pool(host, {})

    # -- pool management --------------------------------------------------

    def _make_socket(self, host: str):
        tls = None
        if self.cba_tls is not None:
            tls = dict(self.cba_tls)
            tls.setdefault('servername', host)

        def construct(backend):
            return HttpSocket(backend, tls=tls,
                              tcp_keepalive_delay=self.tcp_ka_delay,
                              transport=self.cba_transport)
        return construct

    def _add_pool(self, host: str, options: dict) -> ConnectionPool:
        # The reference keys this.pools by bare hostname
        # (lib/agent.js:105-211); integration layers that must
        # distinguish ports pass an explicit poolKey instead of
        # reaching into the dicts.
        key = options.get('poolKey') or host
        port = options.get('port') or self.default_port
        resolver = options.get('resolver')
        if resolver is None:
            resolver = pool_resolver(
                host, port, service=self.service,
                recovery=self.cba_recovery, resolvers=self.resolvers,
                log=self.log)

        pool_opts = {
            'domain': host,
            'resolver': resolver,
            'constructor': self._make_socket(host),
            'maximum': self.maximum,
            'spares': self.spares,
            'log': self.log,
            'recovery': self.cba_recovery,
            'collector': self.collector,
        }
        if self.cba_ping is not None:
            pool_opts['checker'] = self._make_checker(host)
            pool_opts['checkTimeout'] = self.cba_ping_interval or 30000
        if options.get('targetClaimDelay') is not None:
            pool_opts['targetClaimDelay'] = options['targetClaimDelay']
        pool = ConnectionPool(pool_opts)
        if resolver.is_in_state('stopped'):
            resolver.start()
        self.pools[key] = pool
        self.pool_resolvers[key] = resolver
        return pool

    def get_pool(self, host: str) -> ConnectionPool | None:
        return self.pools.get(host)

    getPool = get_pool

    def create_pool(self, host: str, options: dict | None = None) -> None:
        """Pre-create the pool for a host; a duplicate is an error
        (reference lib/agent.js:464-488)."""
        assert not self.cba_stopped, 'agent has been stopped'
        if host in self.pools:
            raise RuntimeError(
                'Attempting to create a pool for a hostname that '
                'already has one: %s' % host)
        self._add_pool(host, options or {})

    createPool = create_pool

    def is_stopped(self) -> bool:
        return self.cba_stopped

    isStopped = is_stopped

    async def stop(self) -> None:
        """Stop all pools and their resolvers
        (reference lib/agent.js:213-265)."""
        assert not self.cba_stopped, 'agent already stopped'
        self.cba_stopped = True
        # Outstanding upgraded sockets hold their slot busy by design;
        # a pool cannot reach 'stopped' until they close, so shutdown
        # reclaims them (the reference never re-manages upgraded
        # sockets at all, lib/agent.js:361-381).
        def reclaim_upgraded():
            for handle in list(self.cba_upgraded):
                if handle.is_in_state('claimed'):
                    handle.close()

        reclaim_upgraded()
        pools = list(self.pools.values())
        resolvers = list(self.pool_resolvers.values())
        for pool in pools:
            pool.stop()
        for pool in pools:
            while not pool.is_in_state('stopped'):
                # An upgrade() that was in flight when stop() began
                # registers its handle only as its claim/response
                # resolves; keep reclaiming while we wait or the pool
                # can never reach 'stopped'.
                reclaim_upgraded()
                await asyncio.sleep(0.01)
        self.cba_upgraded.clear()
        for res in resolvers:
            if not res.is_in_state('stopped'):
                res.stop()
        self.pools = {}
        self.pool_resolvers = {}

    # -- health checking --------------------------------------------------

    def _make_checker(self, host: str):
        def checker(handle, socket):
            # Fire-and-forget by design: the health check owns its
            # whole lifecycle (it releases the claim handle on every
            # path and reports failure through the FSM, never by
            # raising), and the pool's checker callback is sync.
            asyncio.ensure_future(  # cbflow: ignore=A004
                self._check_socket(host, handle, socket))
        return checker

    async def _check_socket(self, host: str, handle, socket) -> None:
        """GET the ping path over this very socket; 5xx or failure
        closes it, success releases it
        (reference lib/agent.js:398-455)."""
        t1 = get_loop().time()
        try:
            resp = await asyncio.wait_for(
                self._do_request_on('GET', host, self.cba_ping, {},
                                    b'', socket),
                timeout=30)
            resp_obj, keep_alive = resp
            latency = (get_loop().time() - t1) * 1000
            if 500 <= resp_obj.status < 600:
                self.log.warning(
                    'health check on %s got %d (latency %.0fms), '
                    'closing', host, resp_obj.status, latency)
                handle.close()
            elif not keep_alive:
                handle.close()
            else:
                # Success stays below INFO (reference changelog #105:
                # per-interval success at INFO was pure noise) and
                # names the pool's domain + latency/path/status
                # (reference changelog #109).
                self.log.debug(
                    'health check on pool "%s" ok (status %d, '
                    'latency %.0fms, path %s)', host,
                    resp_obj.status, latency, self.cba_ping)
                handle.release()
        except Exception as e:
            self.log.warning('health check on %s failed: %r', host, e)
            try:
                handle.close()
            except RuntimeError:
                pass

    # -- requests ---------------------------------------------------------

    async def _do_request_on(self, method: str, host: str, path: str,
                             headers: dict, body: bytes, socket):
        hdrs = {'host': host, 'connection': 'keep-alive'}
        hdrs.update({k.lower(): v for k, v in (headers or {}).items()})
        if body:
            hdrs['content-length'] = str(len(body))
        lines = ['%s %s HTTP/1.1' % (method, path)]
        lines += ['%s: %s' % (k, v) for k, v in hdrs.items()]
        payload = ('\r\n'.join(lines) + '\r\n\r\n').encode('latin-1') + \
            (body or b'')
        socket.writer.write(payload)
        await socket.writer.drain()
        return await _read_response(socket.reader, method)

    async def _claim_for(self, host: str, port: int | None,
                         timeout: float | None):
        """Shared claim plumbing for request()/upgrade(): stopped
        check, lazy pool creation, claim options."""
        if self.cba_stopped:
            raise RuntimeError('agent has been stopped')
        pool = self.pools.get(host)
        if pool is None:
            pool = self._add_pool(host, {'port': port})

        claim_opts = {}
        if timeout is not None:
            claim_opts['timeout'] = timeout
        if self.cba_err_on_empty is not None:
            claim_opts['errorOnEmpty'] = self.cba_err_on_empty
        return await pool.claim(claim_opts)

    async def request(self, method: str, host: str, path: str = '/',
                      headers: dict | None = None, body: bytes = b'',
                      port: int | None = None,
                      timeout: float | None = None) -> HttpResponse:
        """Claim a pooled connection to `host`, run one HTTP request,
        and release/close per keep-alive semantics (the addRequest
        analogue, reference lib/agent.js:275-396)."""
        handle, socket = await self._claim_for(host, port, timeout)
        try:
            resp, keep_alive = await self._do_request_on(
                method, host, path, headers or {}, body, socket)
        except asyncio.CancelledError:
            # Request aborted mid-flight: connection state unknown.
            handle.close()
            raise
        except Exception:
            handle.close()
            raise
        if keep_alive:
            handle.release()
        else:
            handle.close()
        return resp

    async def upgrade(self, host: str, path: str = '/',
                      headers: dict | None = None,
                      protocol: str = 'websocket',
                      port: int | None = None,
                      timeout: float | None = None):
        """Issue an HTTP/1.1 Upgrade on a pooled connection.

        The reference removes an upgraded socket from agent management
        until it closes ('agentRemove' hold,
        reference lib/agent.js:361-381); here, on a 101 response the
        claimed handle is simply never released — the slot stays busy,
        the caller owns the raw socket for the new protocol and MUST
        call handle.close() when finished. Returns
        (response, socket, handle) on 101; (response, None, None)
        otherwise (connection recycled per keep-alive as usual).
        """
        hdrs = {'connection': 'Upgrade', 'upgrade': protocol}
        hdrs.update({k.lower(): v for k, v in (headers or {}).items()})

        handle, socket = await self._claim_for(host, port, timeout)
        try:
            resp, keep_alive = await self._do_request_on(
                'GET', host, path, hdrs, b'', socket)
        except BaseException:
            handle.close()
            raise
        if resp.status == 101:
            # Track the detached handle so agent.stop() can reclaim
            # the slot if the caller never closes it.
            self.cba_upgraded.add(handle)
            handle.on('stateChanged',
                      lambda st: self.cba_upgraded.discard(handle)
                      if st in ('released', 'closed') else None)
            return resp, socket, handle
        if keep_alive:
            handle.release()
        else:
            handle.close()
        return resp, None, None

    async def get(self, host: str, path: str = '/', **kw) -> HttpResponse:
        return await self.request('GET', host, path, **kw)

    async def post(self, host: str, path: str = '/', body: bytes = b'',
                   **kw) -> HttpResponse:
        return await self.request('POST', host, path, body=body, **kw)


class HttpAgent(CueBallAgent):
    """reference lib/agent.js:501-507"""

    def __init__(self, options: dict):
        super().__init__(options, 'http')


class HttpsAgent(CueBallAgent):
    """reference lib/agent.js:509-515"""

    def __init__(self, options: dict):
        super().__init__(options, 'https')
