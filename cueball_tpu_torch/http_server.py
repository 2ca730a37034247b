"""The port's kang routes: ``/kang/health`` and ``/kang/fleet`` over
the port's health monitors and pool monitor, the counterpart of those
two routes of ``cueball_tpu.http_server``.

    GET /kang/health   - the port's health monitors' verdicts
                         (``parallel.health.health_snapshot()``);
                         ?limit=N keeps the newest N monitor rows (the
                         fleet merge always covers all of them)
    GET /kang/fleet    - the pool monitor's attached FleetSampler

The JAX package's server keeps its other routes, which read its own FSM
registry; a deployment that runs both packages serves both servers.
The request parsing and the keep-alive loop are copies of that
server's (HTTP/1.1 persistent connections, Connection: close and
HTTP/1.0 honoured, 400 on a malformed request, 405 on a method other
than GET). That server listens through its transport seam; this one
listens with ``asyncio.start_server``: two read-only routes need no
transport layer.
"""

from __future__ import annotations

import asyncio
import json
import urllib.parse

from .monitor import pool_monitor
from .parallel.health import health_snapshot

_MAX_HEADERS = 64
_MAX_LINE = 8192

_REASONS = {200: b'OK', 400: b'Bad Request', 404: b'Not Found',
            405: b'Method Not Allowed'}


def _json_default(o):
    return repr(o)


async def _read_request(reader):
    """Parse one request. Returns (method, path, keep_alive) or a
    status int on protocol error, or None on clean EOF."""
    try:
        line = await reader.readline()
    except ValueError:       # line exceeded the stream's 64 KiB limit
        return 400
    if not line:
        return None
    if len(line) > _MAX_LINE:
        return 400
    parts = line.decode('latin-1').rstrip('\r\n').split(' ')
    if len(parts) != 3 or not parts[1].startswith('/'):
        return 400
    method, path, version = parts
    if version not in ('HTTP/1.1', 'HTTP/1.0'):
        return 400

    headers = {}
    # One extra iteration beyond the cap belongs to the blank
    # terminator line, so exactly _MAX_HEADERS headers are accepted.
    for _ in range(_MAX_HEADERS + 1):
        try:
            h = await reader.readline()
        except ValueError:
            return 400
        if h in (b'\r\n', b'\n'):
            break
        if h == b'' or len(h) > _MAX_LINE:
            return 400
        name, sep, value = h.decode('latin-1').partition(':')
        if not sep:
            return 400
        headers[name.strip().lower()] = value.strip()
    else:
        return 400

    conn = headers.get('connection', '').lower()
    if version == 'HTTP/1.0':
        keep_alive = conn == 'keep-alive'
    else:
        keep_alive = conn != 'close'

    # Drain any request body so keep-alive never parses body bytes as
    # the next request line; a chunked body closes the connection after
    # the response.
    if 'transfer-encoding' in headers:
        keep_alive = False
    else:
        clen = headers.get('content-length')
        if clen is not None:
            try:
                n = int(clen)
            except ValueError:
                return 400
            if n < 0 or n > (1 << 20):
                return 400
            try:
                await reader.readexactly(n)
            except asyncio.IncompleteReadError:
                return None
    return method, path, keep_alive


def _bad(ctype: str, message: str):
    return 400, ctype, json.dumps({'error': message}).encode()


def route(method: str, path: str, monitor=None):
    """Dispatch one request; returns (status, ctype, body).
    ``monitor`` is the pool monitor whose attached sampler
    ``/kang/fleet`` shows (default: the port's ``pool_monitor``)."""
    if method != 'GET':
        return 405, 'application/json', b'{"error": "GET only"}'
    path, _, query = path.partition('?')
    ctype = 'application/json'
    try:
        if path == '/kang/fleet':
            mon = pool_monitor if monitor is None else monitor
            body = json.dumps(mon.fleet_snapshot(),
                              default=_json_default).encode()
        elif path == '/kang/health':
            params = urllib.parse.parse_qs(query, keep_blank_values=True)
            unknown = sorted(set(params) - {'limit'})
            if unknown:
                return _bad(ctype, 'unknown parameter(s) %s; supported: '
                                   'limit' % ', '.join(unknown))
            payload = health_snapshot()
            if 'limit' in params:
                try:
                    limit = int(params['limit'][-1])
                except ValueError:
                    return _bad(ctype, 'limit must be an integer, got %r'
                                % params['limit'][-1])
                if limit < 0:
                    return _bad(ctype, 'limit must be >= 0, got %d' % limit)
                payload = dict(payload,
                               monitors=payload['monitors'][-limit:]
                               if limit else [])
            body = json.dumps(payload, default=_json_default).encode()
        else:
            return 404, ctype, b'{"error": "not found"}'
    except (KeyError, ValueError, IndexError) as e:
        return 404, ctype, json.dumps({'error': str(e)}).encode()
    return 200, ctype, body


async def _serve_client(reader, writer, monitor=None):
    try:
        while True:
            req = await _read_request(reader)
            if req is None:
                return
            if isinstance(req, int):        # protocol error
                status, ctype, body = (req, 'application/json',
                                       b'{"error": "bad request"}')
                keep_alive = False
            else:
                method, path, keep_alive = req
                status, ctype, body = route(method, path, monitor)
            writer.write(
                b'HTTP/1.1 %d %s\r\nContent-Type: %s\r\n'
                b'Content-Length: %d\r\nConnection: %s\r\n\r\n' % (
                    status, _REASONS.get(status, b'Error'),
                    ctype.encode(), len(body),
                    b'keep-alive' if keep_alive else b'close') + body)
            await writer.drain()
            if not keep_alive:
                return
    except ConnectionError:
        pass
    finally:
        writer.close()


async def serve_monitor(port: int = 0, host: str = '127.0.0.1',
                        monitor=None):
    """Start the endpoint on the running loop; returns the asyncio
    server (its bound port: ``server.sockets[0].getsockname()[1]``).
    Fetch from another thread than the loop's: a blocking client on
    the serving loop deadlocks against it."""
    return await asyncio.start_server(
        lambda r, w: _serve_client(r, w, monitor=monitor), host, port)
