"""DNS service-discovery resolver.

Rebuild of reference `lib/resolver.js:152-1377`: the 23-state
SRV -> AAAA -> A -> process -> sleep workflow with TTL-driven refresh.

Workflow (reference lib/resolver.js:153-178): query SRV records for
`service.domain`; for each resulting (name, port) fill in addresses via
AAAA then A lookups (exploiting the SRV response's Additional section
when present); diff the resulting backend set against the previous one,
emitting 'removed' then 'added'; then sleep until the earliest TTL
expiry and resume at the stage whose data expired.

Policy matrix preserved (SURVEY.md §7.4 calls it compatibility-critical):
- SRV NXDOMAIN/NODATA/NOTIMP: fall through to plain AAAA/A on the base
  domain; re-check SRV in 60min, or the NODATA SOA TTL when present.
- SRV REFUSED: non-retryable; other errors: exponential backoff retries.
- Anti-flap: after retries exhaust, only fall back to A/AAAA if SRV has
  never succeeded before (node-moray depends on this accidental API:
  reference lib/resolver.js:687-723).
- AAAA NODATA/NOTIMP: skip name quietly (cached NIC_CACHE_TTL);
  A NODATA with v6 present: skip; NXDOMAIN/REFUSED: non-retryable.
- Multi-resolver failures vote on the most common rcode
  (reference lib/resolver.js:1227-1259).
- IPv6 lookups are skipped entirely when no global v6 NIC exists
  (60s-cached probe, reference lib/resolver.js:738-772).
- Nameserver bootstrap ("Dynamic Resolver mode"): when `resolvers` is a
  single DNS name, a shared refcounted bootstrap resolver looks it up
  via _dns._udp and feeds this resolver's nameserver list
  (reference lib/resolver.js:475-540, docs/api.adoc:752-801).
"""

from __future__ import annotations

import logging
import math
import os
# Interface enumeration (not byte movement): getifaddrs-style
# probing has no Transport verb, so the raw import stays licensed.
import socket  # cblint: ignore=C110

from . import dns_client as mod_nsc
from . import trace as mod_trace
from . import utils as mod_utils
from .events import EventEmitter
from .fsm import FSM
from .utils import delay as gen_delay

NIC_CACHE_TTL_S = 60.0

_nic_cache: dict = {'updated': None, 'have_v6': False}


def _probe_global_v6() -> bool:
    """True if this host has a global (non-loopback) IPv6 address. Uses
    a connected UDP socket, which sends no packets
    (the os.networkInterfaces() analogue, reference
    lib/resolver.js:741-755)."""
    try:
        s = socket.socket(socket.AF_INET6, socket.SOCK_DGRAM)
        try:
            s.connect(('2001:4860:4860::8888', 53))
            addr = s.getsockname()[0]
            return addr not in ('::1', '::')
        finally:
            s.close()
    except OSError:
        return False


def have_global_v6() -> bool:
    now = mod_utils.get_clock().monotonic()
    if _nic_cache['updated'] is None or \
            now - _nic_cache['updated'] > NIC_CACHE_TTL_S:
        _nic_cache['have_v6'] = _probe_global_v6()
        _nic_cache['updated'] = now
    return _nic_cache['have_v6']


def _read_resolv_conf(path='/etc/resolv.conf') -> list[str]:
    """Parse nameserver lines; [8.8.8.8, 8.8.4.4] fallback
    (reference lib/resolver.js:492-510)."""
    import re
    try:
        with open(path) as f:
            content = f.read()
    except OSError:
        return ['8.8.8.8', '8.8.4.4']
    out = []
    for line in content.split('\n'):
        m = re.match(r'^\s*nameserver\s+([^\s]+)\s*$', line)
        if m:
            from .resolver import _is_ip
            if _is_ip(m.group(1)):
                out.append(m.group(1))
    return out or ['8.8.8.8', '8.8.4.4']


class DNSResolverFSM(FSM):
    """Inner DNS resolver machine; the public DNSResolver() factory wraps
    it in the 5-state ResolverFSM contract
    (reference lib/resolver.js:408 returns the wrapper)."""

    # Shared bootstrap registry + per-concurrency client cache
    # (reference lib/resolver.js:411-413,385-392).
    bootstrap_resolvers: dict = {}
    global_ns_clients: dict = {}

    def __init__(self, options: dict):
        if not isinstance(options, dict):
            raise AssertionError('options must be a dict')
        resolvers = options.get('resolvers')
        if resolvers is not None and not (
                isinstance(resolvers, list) and
                all(isinstance(r, str) for r in resolvers)):
            raise AssertionError(
                'options.resolvers must be a list of strings')
        domain = options.get('domain')
        if not isinstance(domain, str):
            raise AssertionError('options.domain must be a string')

        self.r_uuid = mod_utils.make_uuid()
        self.r_resolvers = list(resolvers or [])
        self.r_domain = domain
        self.r_service = options.get('service') or '_http._tcp'
        self.r_maxres = options.get('maxDNSConcurrency') or 3
        self.r_defport = options.get('defaultPort') or 80
        self.r_is_bootstrap = bool(options.get('_isBootstrap'))

        if self.r_is_bootstrap:
            # Bootstrap resolvers look up the DNS service itself and try
            # all possible resolvers (reference lib/resolver.js:265-281).
            self.r_service = '_dns._udp'
            self.r_defport = 53
            self.r_maxres = 10
            self.r_ref_count = 0

        self.r_log = mod_utils.make_child_logger(
            options.get('log') or logging.getLogger('cueball.dns'),
            component='CueBallDNSResolver', domain=self.r_domain)

        recovery = options.get('recovery')
        if not isinstance(recovery, dict):
            raise AssertionError('options.recovery is required')
        self.r_recovery = recovery

        from .utils import assert_recovery
        dns_srv_recov = recovery.get('default')
        dns_recov = recovery.get('default')
        if recovery.get('dns'):
            dns_srv_recov = recovery['dns']
            dns_recov = recovery['dns']
        if recovery.get('dns_srv'):
            dns_srv_recov = recovery['dns_srv']
        assert_recovery(dns_srv_recov, 'recovery.dns_srv')
        assert_recovery(dns_recov, 'recovery.dns')

        def mkretry(r):
            return {
                'max': r['retries'], 'count': r['retries'],
                'timeout': r['timeout'], 'minDelay': r['delay'],
                'delay': r['delay'],
                'delaySpread': r.get('delaySpread') or 0.2,
                'maxDelay': r.get('maxDelay') or math.inf,
            }
        self.r_srv_retry = mkretry(dns_srv_recov)
        self.r_retry = mkretry(dns_recov)

        # Next-refresh deadlines (epoch seconds); normally TTL expiries,
        # error-retry times otherwise (reference lib/resolver.js:330-343).
        now = mod_utils.wall_time()
        self.r_next_service: float | None = now
        self.r_next_v6: float | None = now
        self.r_next_v4: float | None = now

        self.r_last_srv_ttl = 60
        self.r_last_ttl = 60
        self.r_last_error = None

        self.r_srvs: list[dict] = []
        self.r_srv_rem: list[dict] = []
        self.r_srv: dict | None = None
        self.r_backends: dict[str, dict] = {}

        self.r_bootstrap = None
        self.r_bootstrap_res: dict = {}

        # Injectable for tests (the reference stubs mname-client).
        self.r_nsclient = options.get('dnsClient')
        if self.r_nsclient is None:
            cache = DNSResolverFSM.global_ns_clients
            self.r_nsclient = cache.get(self.r_maxres)
            if self.r_nsclient is None:
                self.r_nsclient = mod_nsc.DnsClient(
                    concurrency=self.r_maxres)
                cache[self.r_maxres] = self.r_nsclient

        self.r_stopping = False
        self.r_have_seen_srv = False
        self.r_have_seen_addr = False
        self.r_counters: dict[str, int] = {}
        self.r_last_processed = None

        super().__init__('init')

    # -- helpers -----------------------------------------------------------

    def _incr_counter(self, counter: str) -> None:
        self.r_counters[counter] = self.r_counters.get(counter, 0) + 1

    def _hwm_counter(self, counter: str, val) -> None:
        if self.r_counters.get(counter, -math.inf) < val:
            self.r_counters[counter] = val

    def start(self) -> None:
        self.emit('startAsserted')

    def stop(self) -> None:
        self.r_stopping = True
        self.emit('stopAsserted')

    def count(self) -> int:
        return len(self.r_backends)

    def list(self) -> dict:
        return dict(self.r_backends)

    def get_last_error(self):
        return self.r_last_error

    getLastError = get_last_error

    # -- states ------------------------------------------------------------

    def state_init(self, S):
        S.validTransitions(['check_ns'])
        from .monitor import pool_monitor
        self.r_stopping = False
        pool_monitor.register_dns_resolver(self)
        if self.r_bootstrap is not None:
            self.r_bootstrap.r_ref_count -= 1
            if self.r_bootstrap.r_ref_count <= 0:
                self.r_bootstrap.stop()
            self.r_bootstrap = None
        S.goto_state_on(self, 'startAsserted', 'check_ns')

    def state_check_ns(self, S):
        """Figure out which nameservers to use: explicit IPs, a bootstrap
        name, or /etc/resolv.conf (reference lib/resolver.js:465-510)."""
        S.validTransitions(['srv', 'bootstrap_ns'])
        from .resolver import _is_ip
        if self.r_resolvers:
            # 'host@port' is accepted for non-53 nameservers (test rigs);
            # strip the port before deciding IP vs. bootstrap name.
            not_ip = [r for r in self.r_resolvers
                      if _is_ip(r.partition('@')[0]) == 0]
            if not not_ip:
                S.gotoState('srv')
                return
            assert len(not_ip) == 1, \
                'only one bootstrap resolver name is supported'
            self.r_resolvers = []
            boot = DNSResolverFSM.bootstrap_resolvers.get(not_ip[0])
            if boot is None:
                res = DNSResolver({
                    'domain': not_ip[0],
                    'log': self.r_log,
                    'recovery': self.r_recovery,
                    'dnsClient': self.r_nsclient,
                    '_isBootstrap': True,
                })
                boot = res.r_fsm
                DNSResolverFSM.bootstrap_resolvers[not_ip[0]] = boot
            self.r_bootstrap = boot
            boot.r_ref_count += 1
            S.gotoState('bootstrap_ns')
        else:
            self.r_resolvers = _read_resolv_conf()
            S.gotoState('srv')

    def state_bootstrap_ns(self, S):
        S.validTransitions(['srv'])
        boot = self.r_bootstrap

        def on_added(k, srv):
            self.r_bootstrap_res[k] = srv
            self.r_resolvers.append(srv['address'])

        def on_removed(k):
            srv = self.r_bootstrap_res.pop(k)
            assert srv['address'] in self.r_resolvers
            self.r_resolvers.remove(srv['address'])

        # Persistent listeners: survive this state BY DESIGN (the
        # bootstrap keeps feeding r_resolvers for the resolver's whole
        # life, reference lib/resolver.js:513-526) — exempt from the
        # state-scoped registration discipline.
        boot.on('added', on_added)        # cbfsm: ignore=F006
        boot.on('removed', on_removed)    # cbfsm: ignore=F006

        if boot.count() > 0:
            srvs = boot.list()
            self.r_bootstrap_res = srvs
            for k, srv in srvs.items():
                self.r_resolvers.append(srv['address'])
            S.gotoState('srv')
        else:
            S.on(boot, 'added', lambda k, srv: S.gotoState('srv'))
            boot.start()

    # -- SRV section -------------------------------------------------------

    def state_srv(self, S):
        S.validTransitions(['srv_try'])
        r = self.r_srv_retry
        r['delay'] = r['minDelay']
        r['count'] = r['max']
        S.gotoState('srv_try')

    def state_srv_try(self, S):
        S.validTransitions(['aaaa', 'srv_error'])
        name = '%s.%s' % (self.r_service, self.r_domain)
        req = self.resolve(name, 'SRV', self.r_srv_retry['timeout'])

        def on_answers(ans, ttl):
            self.r_next_service = mod_utils.wall_time() + ttl
            self.r_last_srv_ttl = ttl
            self.r_last_ttl = ttl
            self.r_have_seen_srv = True

            # Merge cached v4/v6 expiries from the previous round
            # (reference lib/resolver.js:554-580).
            old_lookup: dict = {}
            for srv in self.r_srvs:
                old_lookup.setdefault(srv['name'], {})[srv['port']] = srv
            for srv in ans:
                old = old_lookup.get(srv['name'], {}).get(srv['port'])
                if old is None:
                    continue
                for fld in ('expiry_v4', 'addresses_v4', 'expiry_v6',
                            'addresses_v6'):
                    if old.get(fld) is not None:
                        srv[fld] = old[fld]

            self.r_srvs = ans
            S.gotoState('aaaa')
        S.on(req, 'answers', on_answers)

        def on_error(err):
            from .resolver import NoNameError, NoRecordsError
            self.r_last_error = RuntimeError(
                'SRV lookup for "%s" failed: %s' % (name, err))
            self.r_last_error.__cause__ = err
            self._incr_counter('srv-failure')

            code = getattr(err, 'code', None)
            if isinstance(err, (NoRecordsError, NoNameError)) or \
                    code == 'NOTIMP':
                # No SRV records: fall through to plain AAAA/A on the
                # base domain; re-check in 60min or the SOA TTL
                # (reference lib/resolver.js:589-644).
                self.r_srvs = [{'name': self.r_domain,
                                'port': self.r_defport}]
                ttl = 60 * 60
                if code == 'NOTIMP':
                    self.r_log.info(
                        'SRV got NOTIMP for %s; retry in %d seconds',
                        self.r_service, ttl)
                else:
                    if getattr(err, 'ttl', None):
                        ttl = err.ttl
                    self.r_log.info(
                        'no SRV records for %s; retry in %d seconds',
                        self.r_service, ttl)
                self.r_next_service = mod_utils.wall_time() + ttl
                self._incr_counter('srv-skipped')
                S.gotoState('aaaa')
            elif code == 'REFUSED':
                # Authoritative server refusing recursion: retrying is
                # pointless (reference lib/resolver.js:646-655).
                self.r_srv_retry['count'] = 0
                S.gotoState('srv_error')
            else:
                S.gotoState('srv_error')
        S.on(req, 'error', on_error)
        req.send()

    def state_srv_error(self, S):
        S.validTransitions(['srv_try', 'aaaa', 'sleep'])
        r = self.r_srv_retry
        r['count'] -= 1
        if r['count'] > 0:
            d = gen_delay(r['delay'], r['delaySpread'])
            S.timeout(d, lambda: S.gotoState('srv_try'))
            r['delay'] *= 2
            if r['delay'] > r['maxDelay']:
                r['delay'] = r['maxDelay']
            return

        self.r_srvs = [{'name': self.r_domain, 'port': self.r_defport}]
        d = mod_utils.wall_time() + self.r_last_srv_ttl
        self.r_next_service = d

        # Anti-flap rules (reference lib/resolver.js:687-723): only fall
        # back to plain-name A/AAAA if SRV has never succeeded.
        if not self.r_have_seen_srv and not self.r_have_seen_addr:
            self.r_log.debug(
                'no SRV records found for service %s, trying as a '
                'plain name', self.r_service)
            S.gotoState('aaaa')
            return
        elif not self.r_have_seen_srv:
            self.r_log.info(
                'no SRV records found for service %s, falling back '
                'to A/AAAA for 15min', self.r_service)
            self.r_next_service = mod_utils.wall_time() + 60 * 15
            S.gotoState('aaaa')
            return

        # Wake up for SRV, not A/AAAA.
        if self.r_next_v6 is not None and self.r_next_v6 < d:
            self.r_next_v6 = d
        if self.r_next_v4 is not None and self.r_next_v4 < d:
            self.r_next_v4 = d
        S.gotoState('sleep')

    # -- AAAA section ------------------------------------------------------

    def state_aaaa(self, S):
        S.validTransitions(['aaaa_next', 'a'])
        if have_global_v6():
            self.r_next_v6 = None
            self.r_srv_rem = list(self.r_srvs)
            S.gotoState('aaaa_next')
        else:
            # Re-check after the NIC cache has definitely expired.
            self.r_next_v6 = mod_utils.wall_time() + NIC_CACHE_TTL_S + 0.001
            S.gotoState('a')

    def state_aaaa_next(self, S):
        S.validTransitions(['aaaa_try', 'a'])
        r = self.r_retry
        r['delay'] = r['minDelay']
        r['count'] = r['max']
        if self.r_srv_rem:
            self.r_srv = self.r_srv_rem.pop(0)
            S.gotoState('aaaa_try')
        else:
            S.gotoState('a')

    def state_aaaa_try(self, S):
        S.validTransitions(['aaaa_next', 'aaaa_error'])
        srv = self.r_srv
        from .resolver import _is_ip

        if srv.get('additionals'):
            self.r_log.debug('skipping v6 lookup for %s, using '
                             'additionals from SRV', srv['name'])
            srv['addresses_v6'] = [a for a in srv['additionals']
                                   if _is_ip(a) == 6]
            S.gotoState('aaaa_next')
            return

        now = mod_utils.wall_time()
        if srv.get('expiry_v6') is not None and srv['expiry_v6'] > now:
            if self.r_next_v6 is None or \
                    srv['expiry_v6'] <= self.r_next_v6:
                self.r_next_v6 = srv['expiry_v6']
            S.gotoState('aaaa_next')
            return

        req = self.resolve(srv['name'], 'AAAA', self.r_retry['timeout'])

        def on_answers(ans, ttl):
            d = mod_utils.wall_time() + ttl
            if self.r_next_v6 is None or d <= self.r_next_v6:
                self.r_next_v6 = d
            self.r_last_ttl = ttl
            self.r_have_seen_addr = True
            srv['expiry_v6'] = d
            srv['addresses_v6'] = [v['address'] for v in ans]
            S.gotoState('aaaa_next')
        S.on(req, 'answers', on_answers)

        def on_error(err):
            from .resolver import NoRecordsError
            code = getattr(err, 'code', None)
            if isinstance(err, NoRecordsError) or code == 'NOTIMP':
                # Name likely has only A records; skip quietly, cached
                # like the NIC data (reference lib/resolver.js:832-851).
                srv['expiry_v6'] = mod_utils.wall_time() + NIC_CACHE_TTL_S
                S.gotoState('aaaa_next')
                return
            elif code == 'REFUSED':
                self.r_retry['count'] = 0
            self.r_last_error = RuntimeError(
                'IPv6 (AAAA) lookup failed for "%s": %s' % (
                    srv['name'], err))
            self.r_last_error.__cause__ = err
            S.gotoState('aaaa_error')
        S.on(req, 'error', on_error)
        req.send()

    def state_aaaa_error(self, S):
        S.validTransitions(['aaaa_try', 'aaaa_next'])
        r = self.r_retry
        r['count'] -= 1
        if r['count'] > 0:
            d = gen_delay(r['delay'], r['delaySpread'])
            S.timeout(d, lambda: S.gotoState('aaaa_try'))
            r['delay'] *= 2
            if r['delay'] > r['maxDelay']:
                r['delay'] = r['maxDelay']
        else:
            d = mod_utils.wall_time() + 60 * 60
            if self.r_next_v6 is None or d <= self.r_next_v6:
                self.r_next_v6 = d
            S.gotoState('aaaa_next')

    # -- A section ---------------------------------------------------------

    def state_a(self, S):
        S.validTransitions(['a_next'])
        self.r_next_v4 = None
        self.r_srv_rem = list(self.r_srvs)
        S.gotoState('a_next')

    def state_a_next(self, S):
        S.validTransitions(['a_try', 'process'])
        r = self.r_retry
        r['delay'] = r['minDelay']
        r['count'] = r['max']
        if self.r_srv_rem:
            self.r_srv = self.r_srv_rem.pop(0)
            S.gotoState('a_try')
        else:
            S.gotoState('process')

    def state_a_try(self, S):
        S.validTransitions(['a_next', 'a_error'])
        srv = self.r_srv
        from .resolver import _is_ip

        if srv.get('additionals'):
            self.r_log.debug('skipping v4 lookup for %s, using '
                             'additionals from SRV', srv['name'])
            srv['addresses_v4'] = [a for a in srv['additionals']
                                   if _is_ip(a) == 4]
            S.gotoState('a_next')
            return

        now = mod_utils.wall_time()
        if srv.get('expiry_v4') is not None and srv['expiry_v4'] > now:
            if self.r_next_v4 is None or \
                    srv['expiry_v4'] <= self.r_next_v4:
                self.r_next_v4 = srv['expiry_v4']
            S.gotoState('a_next')
            return

        req = self.resolve(srv['name'], 'A', self.r_retry['timeout'])

        def on_answers(ans, ttl):
            d = mod_utils.wall_time() + ttl
            if self.r_next_v4 is None or d <= self.r_next_v4:
                self.r_next_v4 = d
            self.r_last_ttl = ttl
            self.r_have_seen_addr = True
            srv['expiry_v4'] = d
            srv['addresses_v4'] = [v['address'] for v in ans]
            S.gotoState('a_next')
        S.on(req, 'answers', on_answers)

        def on_error(err):
            from .resolver import NoNameError, NoRecordsError
            code = getattr(err, 'code', None)
            if isinstance(err, NoRecordsError):
                # NODATA for A: fine if we already have v6 addresses
                # (reference lib/resolver.js:958-973).
                if srv.get('addresses_v6'):
                    S.gotoState('a_next')
                    return
                self.r_retry['count'] = 0
            elif isinstance(err, NoNameError):
                self.r_retry['count'] = 0
            elif code == 'REFUSED':
                self.r_retry['count'] = 0
            self.r_last_error = RuntimeError(
                'IPv4 (A) lookup for "%s" failed: %s' % (
                    srv['name'], err))
            self.r_last_error.__cause__ = err
            S.gotoState('a_error')
        S.on(req, 'error', on_error)
        req.send()

    def state_a_error(self, S):
        S.validTransitions(['a_try', 'a_next'])
        r = self.r_retry
        r['count'] -= 1
        if r['count'] > 0:
            d = gen_delay(r['delay'], r['delaySpread'])
            S.timeout(d, lambda: S.gotoState('a_try'))
            r['delay'] *= 2
            if r['delay'] > r['maxDelay']:
                r['delay'] = r['maxDelay']
        else:
            d = mod_utils.wall_time() + self.r_last_ttl
            if self.r_next_v4 is None or d <= self.r_next_v4:
                self.r_next_v4 = d
            S.gotoState('a_next')

    # -- process + sleep ---------------------------------------------------

    def state_process(self, S):
        """Diff new backends vs. old; emit 'removed' then 'added' then
        'updated' (reference lib/resolver.js:1024-1108)."""
        S.validTransitions(['sleep'])
        from .resolver import srv_key

        old_backends = self.r_backends
        new_backends: dict[str, dict] = {}
        all_addrs: list[str] = []
        for srv in self.r_srvs:
            srv['addresses'] = list(srv.get('addresses_v6') or []) + \
                list(srv.get('addresses_v4') or [])
            for addr in srv['addresses']:
                final = {'name': srv['name'], 'port': srv['port'],
                         'address': addr}
                all_addrs.append(addr)
                new_backends[srv_key(final)] = final

        if not new_backends:
            err = RuntimeError(
                'failed to find any DNS records for (%s.)%s' % (
                    self.r_service, self.r_domain))
            err.__cause__ = self.r_last_error
            self._incr_counter('empty-set')
            self.r_log.warning('finished processing: %s', err)
            self.emit('updated', err)
            S.gotoState('sleep')
            return

        removed = [k for k in old_backends if k not in new_backends]
        added = [k for k in new_backends if k not in old_backends]

        self.r_backends = new_backends

        if old_backends and (removed or added):
            self.r_log.info('records changed in DNS: added=%r '
                            'removed=%r', added, removed)

        for k in removed:
            self.emit('removed', k)
            self._incr_counter('backend-removed')
        for k in added:
            self.emit('added', k, new_backends[k])
            self._incr_counter('backend-added')

        if self.r_is_bootstrap:
            gone = [r for r in self.r_resolvers if r not in all_addrs]
            self.r_resolvers = all_addrs
            if gone:
                self.r_log.info(
                    'removed %d resolvers from bootstrap', len(gone))

        self.emit('updated')
        self.r_last_processed = {'added': added, 'removed': removed}
        S.gotoState('sleep')

    def state_sleep(self, S):
        S.validTransitions(['init', 'srv', 'aaaa', 'a'])
        if self.r_stopping:
            S.gotoState('init')
            return

        now = mod_utils.wall_time()
        min_delay = (self.r_next_service or now) - now
        state = 'srv'
        if self.r_next_v6 is not None and \
                self.r_next_v6 - now < min_delay:
            min_delay = self.r_next_v6 - now
            state = 'aaaa'
        if self.r_next_v4 is not None and \
                self.r_next_v4 - now < min_delay:
            min_delay = self.r_next_v4 - now
            state = 'a'

        self._hwm_counter('max-sleep', round(min_delay * 1000))

        if min_delay < 0:
            S.gotoState(state)
        else:
            # Forward-only TTL spread (1.0 to 1.0+spread): re-querying a
            # cache early just returns the same answer
            # (reference lib/resolver.js:1129-1143).
            d = min_delay * (
                1 + mod_utils.get_rng().random() *
                self.r_retry['delaySpread'])
            self.r_log.debug('sleeping %.2fs until next %s expiry',
                             d, state)
            S.timeout(d * 1000, lambda: S.gotoState(state))
            S.goto_state_on(self, 'stopAsserted', 'init')

    # -- lookup helper -----------------------------------------------------

    def resolve(self, domain: str, rtype: str, timeout: float):
        """One lookup as an EventEmitter with .send(); emits
        'answers'(list, minTTL) or 'error'(err)
        (reference lib/resolver.js:1210-1377)."""
        from .resolver import NoNameError, NoRecordsError

        opts = {'domain': domain, 'type': rtype, 'timeout': timeout,
                'resolvers': self.r_resolvers}
        if self.r_is_bootstrap:
            opts['errorThreshold'] = min(
                self.r_maxres, len(self.r_resolvers))

        em = EventEmitter()

        def send():
            # Each send() is one wire lookup: give it its own DnsTrace
            # (dns_client adds a dns_query child span per resolver).
            tracer = mod_trace._runtime
            if tracer is not None:
                opts['trace'] = tracer.dns_begin(domain, rtype)
            self.r_nsclient.lookup(opts, on_lookup)
        em.send = send

        def on_lookup(err, msg):
            dns_trace = opts.get('trace')
            if dns_trace is not None:
                # Wire round-trip is over (post-processing below is
                # local); rcode voting may still rewrite err for the
                # caller, but the wire outcome is what we time.
                dns_trace.done('error' if err is not None else 'ok',
                               err)
                opts['trace'] = None
            # Multi-error: the responding resolvers vote for the most
            # common rcode (reference lib/resolver.js:1227-1259).
            if err is not None and \
                    getattr(err, 'name', None) == 'MultiError':
                codes: dict[str, int] = {}
                for e in err.errors():
                    if getattr(e, 'name', None) == 'TimeoutError':
                        self._incr_counter('timeout')
                        continue
                    code = getattr(e, 'code', None)
                    if code is None:
                        continue
                    codes[code] = codes.get(code, 0) + 1
                    self._incr_counter('rcode-' + code.lower())
                if codes:
                    err.code = sorted(codes, key=lambda c: -codes[c])[0]
            if err is not None and \
                    getattr(err, 'code', None) == 'NXDOMAIN':
                err = NoNameError(domain, err)

            # Newer binder returns an SOA TTL for NODATA
            # (reference lib/resolver.js:1266-1279).
            if err is None and msg is not None and \
                    not msg.get_answers():
                ttl = None
                for v in msg.get_authority():
                    if v['type'] == 'SOA' and v['ttl'] > 0:
                        ttl = v['ttl']
                err = NoRecordsError(domain, rtype, ttl)

            if err is not None:
                code = getattr(err, 'code', None)
                if code:
                    self._incr_counter('rcode-' + str(code).lower())
                em.emit('error', err)
                return

            answers = msg.get_answers()
            min_ttl = None
            ans: list[dict] = []
            self._incr_counter('rcode-ok')

            if rtype in ('A', 'AAAA'):
                for a in answers:
                    if a['type'] != rtype:
                        if a['type'] in ('CNAME', 'DNAME'):
                            self._incr_counter('cname')
                            continue
                        self._incr_counter('unknown-rrtype')
                        self.r_log.warning(
                            'got unsupported answer rrtype: %s',
                            a['type'])
                        continue
                    if min_ttl is None or a['ttl'] < min_ttl:
                        min_ttl = a['ttl']
                    ans.append({'name': a['name'],
                                'address': a['target']})
            elif rtype == 'SRV':
                # Exploit the Additional section to skip A/AAAA round
                # trips (reference lib/resolver.js:1318-1343).
                cache: dict[str, list] = {}
                for rr in msg.get_additionals():
                    if rr['type'] not in ('A', 'AAAA'):
                        if rr['type'] in ('CNAME', 'DNAME', 'OPT'):
                            continue
                        self._incr_counter('unknown-rrtype')
                        self.r_log.warning(
                            'got unsupported additional rrtype: %s',
                            rr['type'])
                        continue
                    if rr.get('target'):
                        if min_ttl is None or rr['ttl'] < min_ttl:
                            min_ttl = rr['ttl']
                        cache.setdefault(rr['name'], []).append(
                            rr['target'])
                for a in answers:
                    if a['type'] != 'SRV':
                        if a['type'] in ('CNAME', 'DNAME'):
                            self._incr_counter('cname')
                            continue
                        self._incr_counter('unknown-rrtype')
                        self.r_log.warning(
                            'got unsupported answer rrtype: %s',
                            a['type'])
                        continue
                    if min_ttl is None or a['ttl'] < min_ttl:
                        min_ttl = a['ttl']
                    obj = {'name': a['target'], 'port': a['port']}
                    if a['target'] in cache:
                        self._incr_counter('additionals-used')
                        obj['additionals'] = cache[a['target']]
                    ans.append(obj)
            else:
                raise ValueError('Invalid record type ' + rtype)

            if not ans:
                em.emit('error', NoRecordsError(domain, rtype))
                return
            em.emit('answers', ans, min_ttl)

        return em


def DNSResolver(options: dict):
    """Build a DNS resolver wrapped in the public 5-state ResolverFSM
    contract (constructor-returns-wrapper, reference
    lib/resolver.js:408)."""
    from .resolver import ResolverFSM
    inner = DNSResolverFSM(options)
    return ResolverFSM(inner, options)
