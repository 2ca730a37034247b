"""Kang-style debug HTTP server of the port: the JAX package's
``cueball_tpu.http_server`` over the port's pool monitor, tracer,
wiretap and health monitors.

The reference exposes pool-monitor snapshots over Joyent's kang
protocol, with the HTTP server supplied by the consumer (kang is a
devDependency; reference lib/pool-monitor.js:60-216,
test/monitor.test.js). Here the framework ships its own asyncio HTTP
endpoint: persistent HTTP/1.1 connections (Connection: close and
HTTP/1.0 honored), strict request-line/header parsing (400 on
malformed, 405 on non-GET), and the kang service-ident handshake —
/kang/snapshot leads with the `service` block (name, component, ident,
version, pid) that kang aggregators use to identify an agent, built
from PoolMonitor.to_kang_options().

    GET /kang/snapshot          - service ident + all registered objects
    GET /kang/types             - ['pool', 'set', 'dns_res']
    GET /kang/objects/<type>    - ids of registered objects of a type
    GET /kang/obj/<type>/<id>   - one object's snapshot
    GET /kang/fleet             - attached FleetSampler's batched decisions
    GET /kang/shards            - started FleetRouters' shard snapshots
    GET /kang/traces            - claim/DNS trace ring as NDJSON spans;
                                  ?limit=N keeps the newest N traces,
                                  ?backend=<key> keeps only traces with
                                  a span attributed to that backend
    GET /kang/health            - the port's health monitors' verdicts
                                  (``parallel.health.health_snapshot()``);
                                  ?limit=N keeps the newest N monitor
                                  rows (the fleet merge always covers
                                  all of them)
    GET /kang/profile           - claim-path profile as collapsed-stack
                                  flamegraph text (ledger phases +
                                  sampler hits; empty when idle);
                                  ?phase=<name> keeps that phase's
                                  stacks
    GET /kang/transport         - transport wire ledger: per-seam
                                  byte/syscall counters, socket_wait
                                  wire totals and loop-lag stats;
                                  ?transport=<name> / ?seam=<name>
                                  narrow the counter table
    GET /metrics                - prometheus text metrics (collector)
"""

from __future__ import annotations

import asyncio
import json
import os
import urllib.parse

from . import profile as mod_profile
from . import trace as mod_trace
from . import wiretap as mod_wiretap
from .monitor import pool_monitor
from .parallel.health import health_snapshot

_MAX_HEADERS = 64
_MAX_LINE = 8192

_REASONS = {200: b'OK', 400: b'Bad Request', 404: b'Not Found',
            405: b'Method Not Allowed'}


def _json_default(o):
    return repr(o)


def _kang_snapshot(monitor) -> dict:
    """The kang agent handshake: service ident first, then stats and
    the per-type object listings (kang snapshot shape; reference
    lib/pool-monitor.js:60-79 toKangOptions feeds the same fields to
    the kang server)."""
    opts = monitor.to_kang_options()
    snap = {
        'service': {
            'name': opts['service_name'],
            'component': __name__.rpartition('.')[0],
            'ident': opts['ident'],
            'version': opts['version'],
            'pid': os.getpid(),
        },
        'stats': opts['stats'](),
    }
    snap.update(monitor.snapshot())
    return snap


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


def _limit(params, ctype):
    """``?limit=N`` of ``params``: (N or None, None), or (None, a 400
    response) when it is malformed."""
    if 'limit' not in params:
        return None, None
    try:
        limit = int(params['limit'][-1])
    except ValueError:
        return None, _bad(ctype, 'limit must be an integer, got %r'
                          % params['limit'][-1])
    if limit < 0:
        return None, _bad(ctype, 'limit must be >= 0, got %d' % limit)
    return limit, None


def _transport_payload(params, ctype):
    """The wiretap ledger for ``/kang/transport``: (payload, None), or
    (None, a 400 response) for a malformed or unknown parameter."""
    unknown = sorted(set(params) - {'transport', 'seam'})
    if unknown:
        return None, _bad(ctype, 'unknown parameter(s) %s; supported: '
                                 'transport, seam' % ', '.join(unknown))
    seam = None
    if 'seam' in params:
        seam = params['seam'][-1]
        if seam not in mod_wiretap.SEAMS:
            return None, _bad(ctype, 'unknown seam %r; one of %s' % (
                seam, ', '.join(mod_wiretap.SEAMS)))
    transports = mod_wiretap.snapshot()
    if 'transport' in params:
        tname = params['transport'][-1]
        if tname not in transports:
            return None, _bad(ctype, 'unknown transport %r; active: %s' % (
                tname, ', '.join(sorted(transports)) or '(none)'))
        transports = {tname: transports[tname]}
    if seam is not None:
        transports = {t: {seam: seams[seam]}
                      for t, seams in transports.items() if seam in seams}
    return {'enabled': mod_wiretap.wiretap_enabled(),
            'transports': transports,
            'wire_ms': mod_wiretap.wire_totals(),
            'loop_lag': mod_wiretap.loop_lag_stats()}, None


def route(method: str, path: str, monitor=None, collector=None):
    """Dispatch one request; returns (status, ctype, body).
    ``monitor`` is the pool monitor the object routes and
    ``/kang/fleet`` read (default: the port's ``pool_monitor``);
    ``collector`` serves ``/metrics``."""
    if method != 'GET':
        return 405, 'application/json', b'{"error": "GET only"}'
    path, _, query = path.partition('?')
    ctype = 'application/json'
    mon = pool_monitor if monitor is None else monitor
    try:
        if path == '/kang/snapshot':
            body = json.dumps(_kang_snapshot(mon),
                              default=_json_default).encode()
        elif path == '/kang/types':
            body = json.dumps(mon.list_types()).encode()
        elif path.startswith('/kang/objects/'):
            t = path.split('/')[3]
            body = json.dumps(mon.list_objects(t)).encode()
        elif path.startswith('/kang/obj/'):
            _, _, _, t, id_ = path.split('/', 4)
            body = json.dumps(mon.get(t, id_),
                              default=_json_default).encode()
        elif path == '/kang/fleet':
            body = json.dumps(mon.fleet_snapshot(),
                              default=_json_default).encode()
        elif path == '/kang/shards':
            body = json.dumps(
                {'routers': [r.snapshot()
                             for r in mod_trace._active_fleet_routers()]},
                default=_json_default).encode()
        elif path == '/kang/traces':
            # Completed claim/DNS traces, one OTLP-field-named span per
            # line (see trace.py). Empty body when tracing is off.
            params = urllib.parse.parse_qs(query, keep_blank_values=True)
            limit, bad = _limit(params, ctype)
            if bad is not None:
                return bad
            backend = None
            if 'backend' in params:
                backend = params['backend'][-1]
                if not mod_trace.backend_known(backend):
                    return _bad(ctype, 'unknown backend %r' % backend)
            body = mod_trace.filter_ndjson(
                mod_trace.export_ndjson(), limit, backend).encode()
            ctype = 'application/x-ndjson'
        elif path == '/kang/health':
            params = urllib.parse.parse_qs(query, keep_blank_values=True)
            unknown = sorted(set(params) - {'limit'})
            if unknown:
                return _bad(ctype, 'unknown parameter(s) %s; supported: '
                                   'limit' % ', '.join(unknown))
            limit, bad = _limit(params, ctype)
            if bad is not None:
                return bad
            payload = health_snapshot()
            if limit is not None:
                payload = dict(payload,
                               monitors=payload['monitors'][-limit:]
                               if limit else [])
            body = json.dumps(payload, default=_json_default).encode()
        elif path == '/kang/profile':
            # Collapsed-stack flamegraph text: one "frame;frame N" line
            # per ledger phase and sampler bucket; feed to any
            # flamegraph renderer. Empty when nothing was profiled.
            # ?phase=<name> keeps only that phase's stacks.
            params = urllib.parse.parse_qs(query, keep_blank_values=True)
            unknown = sorted(set(params) - {'phase'})
            if unknown:
                return _bad(ctype, 'unknown parameter(s) %s; supported: '
                                   'phase' % ', '.join(unknown))
            phase = None
            if 'phase' in params:
                phase = params['phase'][-1]
                if phase not in mod_profile.PHASES:
                    return _bad(ctype, 'unknown phase %r; one of %s' % (
                        phase, ', '.join(mod_profile.PHASES)))
            text = mod_profile.flamegraph()
            if phase is not None:
                kept = [ln for ln in text.splitlines()
                        if ln.split(' ')[0].split(';')[1] == phase]
                text = '\n'.join(kept) + '\n' if kept else ''
            body = text.encode()
            ctype = 'text/plain; charset=utf-8'
        elif path == '/kang/transport':
            params = urllib.parse.parse_qs(query, keep_blank_values=True)
            payload, bad = _transport_payload(params, ctype)
            if bad is not None:
                return bad
            body = json.dumps(payload, default=_json_default).encode()
        elif path == '/metrics' and collector is not None:
            body = collector.collect().encode()
            ctype = 'text/plain; version=0.0.4'
        else:
            return 404, ctype, b'{"error": "not found"}'
    except (KeyError, ValueError, IndexError) as e:
        return 404, ctype, json.dumps({'error': str(e)}).encode()
    return 200, ctype, body


async def _serve_client(reader, writer, monitor=None, collector=None):
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
                status, ctype, body = route(method, path, monitor, collector)
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
                        collector=None, transport=None, monitor=None):
    """Start the kang endpoint on the running loop; returns the asyncio
    server (its bound port: ``server.sockets[0].getsockname()[1]``). The
    listening socket comes from the Transport seam (default
    AsyncioTransport). Fetch from another thread than the loop's: a
    blocking client on the serving loop deadlocks against it."""
    from . import transport as mod_transport
    return await mod_transport.get_transport(transport).serve(
        lambda r, w: _serve_client(r, w, monitor=monitor,
                                   collector=collector),
        host, port)
