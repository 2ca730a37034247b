"""Resolvers: service discovery for pools and sets.

Rebuild of reference `lib/resolver.js`. Three pieces:

- :class:`ResolverFSM` — the thin public 5-state wrapper
  (stopped/starting/running/failed/stopping) over an inner resolver that
  emits ``updated(err?)`` and ``added``/``removed``
  (reference lib/resolver.js:66-150; exported "for testing only" there,
  and used by the static resolver and test fixtures).
- :class:`StaticIpResolver` — emits a fixed backend list once on start
  (reference lib/resolver.js:1380-1456).
- :class:`DNSResolver` — full DNS SRV→AAAA→A service-discovery machine
  with TTL-driven refresh (reference lib/resolver.js:152-1377); defined
  in dns_resolver.py and re-exported here.

Plus the backend-identity hash (srv_key, reference lib/resolver.js:1157-1171),
DNS error types (lib/resolver.js:1173-1208), and the
``resolver_for_ip_or_domain`` user-input factory (lib/resolver.js:1459-1573).

Resolver interface contract (reference docs/api.adoc:354-453): methods
``start() stop() count() list() getLastError()``; events ``added(key,
backend)``, ``removed(key)``; FSM states stopped→starting→running⇄failed.
"""

from __future__ import annotations

import base64
import hashlib
import ipaddress
import logging

from . import utils as mod_utils
from .errors import CueBallError
from .events import EventEmitter
from .fsm import FSM


def _is_ip(s: str) -> int:
    """net.isIP equivalent: 4, 6 or 0."""
    try:
        addr = ipaddress.ip_address(s)
    except ValueError:
        return 0
    return addr.version


def srv_key(srv: dict) -> str:
    """Stable unique backend id: base64 SHA-1 of name||port||normalized-ip
    (reference lib/resolver.js:1157-1171). Used as the key in every
    resolver/pool/set backend map."""
    h = hashlib.sha1()
    h.update(str(srv['name']).encode())
    h.update(b'||')
    h.update(str(srv['port']).encode())
    h.update(b'||')
    addr = ipaddress.ip_address(srv['address'])
    if addr.version == 6:
        # ipaddr.js toNormalizedString(): all eight hextets, lowercase,
        # no zero-compression, no leading zeros ('2001:db8:0:0:0:0:0:1').
        norm = ':'.join('%x' % int(p, 16)
                        for p in addr.exploded.split(':'))
        h.update(norm.encode())
    else:
        h.update(str(addr).encode())
    return base64.b64encode(h.digest()).decode()


srvKey = srv_key


# ---------------------------------------------------------------------------
# DNS lookup error types (reference lib/resolver.js:1173-1208)

class NoNameError(CueBallError):
    """NXDOMAIN: the name does not exist."""

    def __init__(self, name: str, cause=None):
        self.dns_name = name
        super().__init__('No records returned for name %s' % name, cause)


class NoRecordsError(CueBallError):
    """NODATA: name exists but has no records of this type; carries the
    SOA minimum TTL when known so re-checks can be scheduled."""

    def __init__(self, name: str, rtype: str, ttl=None):
        self.dns_name = name
        self.dns_type = rtype
        self.ttl = ttl
        super().__init__('No records returned for name %s of type %s' % (
            name, rtype))


class TimeoutError_(CueBallError):
    """All nameservers timed out for this lookup."""

    def __init__(self, name: str):
        self.dns_name = name
        super().__init__(
            'Timeout while contacting resolvers for name %s' % name)


# ---------------------------------------------------------------------------
# Public wrapper FSM (reference lib/resolver.js:66-150)

class ResolverFSM(FSM):
    """Wraps an inner resolver (EventEmitter with start/stop/count/list
    emitting 'updated'/'added'/'removed') in the public 5-state resolver
    contract."""

    def __init__(self, inner, options: dict | None = None):
        options = options or {}
        self.r_fsm = inner
        self.r_last_error = None
        self.r_log = mod_utils.make_child_logger(
            options.get('log') or logging.getLogger('cueball.resolver'),
            component='CueBallResolver')
        super().__init__('stopped')
        # Always-on forwarding, independent of wrapper state
        # (reference lib/resolver.js:72-73).
        inner.on('added', lambda key, backend:
                 self.emit('added', key, backend))
        inner.on('removed', lambda key: self.emit('removed', key))

    # -- public interface ------------------------------------------------

    def start(self) -> None:
        self.emit('startAsserted')

    def stop(self) -> None:
        self.emit('stopAsserted')

    def count(self) -> int:
        return self.r_fsm.count()

    def list(self) -> dict:
        return self.r_fsm.list()

    def get_last_error(self):
        return self.r_last_error

    getLastError = get_last_error

    # -- states ----------------------------------------------------------

    def state_stopped(self, S):
        S.validTransitions(['starting'])
        S.goto_state_on(self, 'startAsserted', 'starting')

    def state_starting(self, S):
        S.validTransitions(['failed', 'running', 'stopping'])
        # Listener registered before start(): the reference relies on
        # inner resolvers deferring their 'updated' emission
        # (lib/resolver.js:113-116 starts first), but an inner that
        # emits synchronously from start() must not be missed.
        def on_updated(err=None):
            if err:
                self.r_last_error = err
                S.gotoState('failed')
            else:
                S.gotoState('running')
        S.on(self.r_fsm, 'updated', on_updated)
        S.goto_state_on(self, 'stopAsserted', 'stopping')
        self.r_fsm.start()

    def state_running(self, S):
        S.validTransitions(['stopping'])
        S.goto_state_on(self, 'stopAsserted', 'stopping')

    def state_failed(self, S):
        S.validTransitions(['running', 'stopping'])

        def on_updated(err=None):
            if not err:
                S.gotoState('running')
        S.on(self.r_fsm, 'updated', on_updated)
        S.goto_state_on(self, 'stopAsserted', 'stopping')

    def state_stopping(self, S):
        S.validTransitions(['stopped'])
        self.r_fsm.stop()
        S.immediate(lambda: S.gotoState('stopped'))


# ---------------------------------------------------------------------------
# Static IP resolver (reference lib/resolver.js:1380-1456)

class _StaticInner(EventEmitter):
    def __init__(self, options: dict):
        super().__init__()
        if not isinstance(options, dict):
            raise AssertionError('options must be a dict')
        default_port = options.get('defaultPort')
        if default_port is not None and not isinstance(default_port, int):
            raise AssertionError('options.defaultPort must be a number')
        backends = options.get('backends')
        if not isinstance(backends, list) or \
                not all(isinstance(b, dict) for b in backends):
            raise AssertionError('options.backends must be a list of dicts')

        self.sr_backends = []
        for i, backend in enumerate(backends):
            addr = backend.get('address')
            if not isinstance(addr, str):
                raise AssertionError(
                    'options.backends[%d].address must be a string' % i)
            if _is_ip(addr) == 0:
                raise AssertionError(
                    'options.backends[%d].address must be an IP address' % i)
            port = backend.get('port')
            if port is None:
                port = default_port
            if not isinstance(port, int) or isinstance(port, bool):
                raise AssertionError(
                    'options.backends[%d].port must be a number' % i)
            self.sr_backends.append({
                'name': '%s:%d' % (addr, port),
                'address': addr,
                'port': port,
            })
        self.sr_state = 'idle'

    def start(self) -> None:
        if self.sr_state != 'idle':
            raise AssertionError(
                'cannot call start() again without calling stop()')
        self.sr_state = 'started'

        def emit_all():
            for be in self.sr_backends:
                self.emit('added', srv_key(be), be)
            self.emit('updated')
        from .runq import defer
        defer(emit_all)

    def stop(self) -> None:
        if self.sr_state != 'started':
            raise AssertionError(
                'cannot call stop() again without calling start()')
        self.sr_state = 'idle'

    def count(self) -> int:
        return len(self.sr_backends)

    def list(self) -> dict:
        return {srv_key(be): be for be in self.sr_backends}


def StaticIpResolver(options: dict) -> ResolverFSM:
    """Build a resolver that emits a fixed IP list once on start().

    Mirrors the reference's constructor-returns-wrapper pattern
    (lib/resolver.js:1413): you get a ResolverFSM whose inner resolver is
    the static list."""
    return ResolverFSM(_StaticInner(options), options)


# ---------------------------------------------------------------------------
# User-input factory (reference lib/resolver.js:1459-1573)

def parse_ip_or_domain(s: str):
    """Parse 'HOSTNAME[:PORT]' into a resolver spec, or return (not raise)
    an Error for well-formed-but-invalid input
    (reference lib/resolver.js:1530-1573)."""
    if not isinstance(s, str):
        raise AssertionError('input must be a string')
    colon = s.rfind(':')
    if colon == -1:
        first = s
        port = None
    else:
        first = s[:colon]
        try:
            port = int(s[colon + 1:], 10)
        except ValueError:
            return ValueError('unsupported port in input: ' + s)
        if port < 0 or port > 65535:
            return ValueError('unsupported port in input: ' + s)

    ret = {}
    if _is_ip(first) == 0:
        ret['kind'] = 'dns'
        ret['cons'] = DNSResolver
        ret['config'] = {'domain': first}
        if port is not None:
            ret['config']['defaultPort'] = port
    else:
        ret['kind'] = 'static'
        ret['cons'] = StaticIpResolver
        ret['config'] = {'backends': [{'address': first, 'port': port}]}
    return ret


def config_for_ip_or_domain(args: dict):
    """Merge user resolverConfig with the parsed spec
    (reference lib/resolver.js:1502-1528)."""
    if not isinstance(args, dict):
        raise AssertionError('args must be a dict')
    if not isinstance(args.get('input'), str):
        raise AssertionError('args.input must be a string')
    rconfig = args.get('resolverConfig')
    if rconfig is not None and not isinstance(rconfig, dict):
        raise AssertionError('args.resolverConfig must be a dict')

    rcfg = dict(rconfig or {})
    spec = parse_ip_or_domain(args['input'])
    if isinstance(spec, Exception):
        return spec
    rcfg.update(spec['config'])
    spec['mergedConfig'] = rcfg
    return spec


def resolver_for_ip_or_domain(args: dict):
    """Build the right resolver (static for IPs, DNS otherwise) from a
    user-supplied 'HOSTNAME[:PORT]' string; returns an Error instance on
    invalid input (reference lib/resolver.js:1485-1500)."""
    spec = config_for_ip_or_domain(args)
    if isinstance(spec, Exception):
        return spec
    return spec['cons'](spec['mergedConfig'])


def pool_resolver(host: str, port: int, *, service: str,
                  recovery: dict, resolvers=None, log=None,
                  max_dns_concurrency: int = 3):
    """The default per-pool resolver, constructed the way the agent
    does it (reference lib/agent.js:117-139) — shared by the agent and
    the httpx/aiohttp integration layers so resolver configuration has
    one owner. Raises (rather than returns) on invalid host input."""
    res = resolver_for_ip_or_domain({
        'input': '%s:%d' % (host, port),
        'resolverConfig': {
            'resolvers': resolvers,
            'service': service,
            'maxDNSConcurrency': max_dns_concurrency,
            'recovery': recovery,
            'log': log,
        }})
    if isinstance(res, Exception):
        raise res
    return res


resolverForIpOrDomain = resolver_for_ip_or_domain
configForIpOrDomain = config_for_ip_or_domain
parseIpOrDomain = parse_ip_or_domain


# DNSResolver lives in its own module (the largest single component,
# reference lib/resolver.js:152-1377); import at the bottom to avoid a
# cycle (dns_resolver imports srv_key and error types from here).
from .dns_resolver import DNSResolver  # noqa: E402

# Pre-0.4 compatibility naming: the public "Resolver" IS the DNS resolver
# (reference lib/resolver.js:9-13).
Resolver = DNSResolver
