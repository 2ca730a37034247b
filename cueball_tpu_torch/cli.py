"""cbresolve: resolve a name the way the framework's pools would.

Rebuild of reference `bin/cbresolve` (396 LoC): static or DNS mode,
--follow live add/remove stream, optional kang debug listener. Usage
(reference bin/cbresolve:41-61):

    cbresolve HOSTNAME[:PORT]              # DNS-based lookup
    cbresolve -S IP[:PORT]...              # static IPs

Options: -f/--follow, -p/--port, -r/--resolvers, -s/--service,
-t/--timeout, -k/--kang-port. Logging off by default; enable with
LOG_LEVEL (reference bin/cbresolve:66-70). DEBUG=1 prints full
tracebacks on failure (reference bin/cbresolve:388-392).
"""

from __future__ import annotations

import argparse
import asyncio
import datetime
import logging
import os
import sys

from .resolver import (StaticIpResolver, config_for_ip_or_domain,
                       parse_ip_or_domain)
from . import utils as mod_utils


def _utc_now_iso() -> str:
    """Timestamp for --follow output, read through the utils clock
    seam so netsim-driven runs stay replayable (cbflow A003)."""
    return datetime.datetime.fromtimestamp(
        mod_utils.wall_time(), datetime.timezone.utc).isoformat()


def parse_time_interval(s: str) -> int:
    """Duration string -> milliseconds: a positive integer with an
    optional "ms"/"s"/"m" suffix ("500", "30s", "5m"); bare numbers are
    milliseconds (reference bin/cbresolve:301-328 parseTimeInterval)."""
    import re
    m = re.match(r'^([1-9][0-9]*)(ms|s|m)?$', s)
    if m is None:
        raise argparse.ArgumentTypeError(
            'invalid time interval: %s' % s)
    n = int(m.group(1))
    unit = m.group(2)
    if unit == 's':
        n *= 1000
    elif unit == 'm':
        n *= 60000
    return n


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog='cbresolve',
        description='Locate services in DNS using the cueball resolver.')
    p.add_argument('names', nargs='+', metavar='HOSTNAME[:PORT]',
                   help='name to resolve (or IPs with -S)')
    p.add_argument('-S', '--static', action='store_true',
                   help='static IP mode')
    p.add_argument('-f', '--follow', action='store_true',
                   help='periodically re-resolve and report changes')
    p.add_argument('-p', '--port', type=int, default=None,
                   help='default backend port')
    p.add_argument('-r', '--resolvers', default=None,
                   help='comma-separated list of DNS resolvers')
    p.add_argument('-s', '--service', default=None,
                   help='"service" name for SRV lookups (_foo._tcp)')
    p.add_argument('-t', '--timeout', type=parse_time_interval,
                   default=5000, metavar='TIMEOUT',
                   help='timeout for lookups (e.g. 500, 500ms, 30s, 5m;'
                        ' bare numbers are milliseconds)')
    p.add_argument('-k', '--kang-port', type=int, default=None,
                   help='start a kang debug listener on this port')
    return p


def _parse_ip_port(s: str, default_port: int | None):
    """IP[:PORT] for -S mode (reference bin/cbresolve:279-299)."""
    spec = parse_ip_or_domain(s)
    if isinstance(spec, Exception):
        raise SystemExit('cbresolve: %s' % spec)
    if spec['kind'] != 'static':
        raise SystemExit(
            'cbresolve: not an IP address: %s' % s)
    be = spec['config']['backends'][0]
    if be['port'] is None:
        be['port'] = default_port if default_port is not None else 80
    return be


async def _amain(args) -> int:
    logging.basicConfig(
        level=os.environ.get('LOG_LEVEL', 'CRITICAL').upper())

    rconfig: dict = {}
    if args.port is not None:
        if args.port < 0 or args.port > 65535:
            print('cbresolve: bad value for -p/--port: %d' % args.port,
                  file=sys.stderr)
            return 2
        rconfig['defaultPort'] = args.port
    if args.resolvers:
        rconfig['resolvers'] = [
            ip for ip in args.resolvers.split(',') if ip]
    if args.service:
        rconfig['service'] = args.service
    rconfig['recovery'] = {
        'default': {'timeout': args.timeout, 'retries': 3, 'delay': 250,
                    'maxDelay': 2000},
    }

    if args.static:
        backends = [_parse_ip_port(s, args.port) for s in args.names]
        resolver = StaticIpResolver({
            'defaultPort': args.port if args.port is not None else 80,
            'backends': backends})
    else:
        if len(args.names) != 1:
            print('cbresolve: exactly one HOSTNAME for DNS mode',
                  file=sys.stderr)
            return 2
        spec = config_for_ip_or_domain({
            'input': args.names[0], 'resolverConfig': rconfig})
        if isinstance(spec, Exception):
            print('cbresolve: %s' % spec, file=sys.stderr)
            return 2
        resolver = spec['cons'](spec['mergedConfig'])

    backends_seen: dict[str, dict] = {}
    done = asyncio.get_running_loop().create_future()

    def on_added(key, backend):
        backends_seen[key] = backend
        if args.follow:
            print('%s added   %16s:%-5d (%s)' % (
                _utc_now_iso(),
                backend['address'], backend['port'], key))
        else:
            print('%-16s %5d %s' % (
                backend['address'], backend['port'], key))

    def on_removed(key):
        old = backends_seen.pop(key, None)
        if args.follow and old is not None:
            print('%s removed %16s:%-5d (%s)' % (
                _utc_now_iso(),
                old['address'], old['port'], key))

    resolver.on('added', on_added)
    resolver.on('removed', on_removed)

    def on_state(st):
        if st == 'running' and not args.follow:
            if not done.done():
                done.set_result(0)
        elif st == 'failed':
            err = resolver.get_last_error()
            if os.environ.get('DEBUG'):
                import traceback
                traceback.print_exception(err)
            else:
                print('error: %s' % err, file=sys.stderr)
            if not done.done():
                done.set_result(1)
    resolver.on('stateChanged', on_state)

    kang_server = None
    if args.kang_port is not None:
        from .http_server import serve_monitor
        kang_server = await serve_monitor(port=args.kang_port)

    resolver.start()

    if args.follow:
        # Run until interrupted.
        try:
            await asyncio.Future()
        except asyncio.CancelledError:
            pass
        return 0

    rc = await done
    resolver.stop()
    if kang_server is not None:
        kang_server.close()
    return rc


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    try:
        return asyncio.run(_amain(args))
    except KeyboardInterrupt:
        return 130


if __name__ == '__main__':
    sys.exit(main())
