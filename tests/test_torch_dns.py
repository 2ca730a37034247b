"""The port's service discovery (``cueball_tpu_torch.dns_client``,
``dns_resolver`` and ``netsim.dns``) against the JAX package's, record
for record.

- The wire codec: query bytes and parsed responses for seeded names and
  types, each package's encoder and parser on the same inputs.
- The resolver scenarios of ``tests/test_dns.py``: each runs once over
  each package, on that package's own virtual-time loop
  (``netsim.run``: its clock and a ``random.Random`` of one seed in the
  package's ``utils``), one package after the other, over that package's
  ``ScriptedDnsClient`` answering from one convention table (a copy of
  ``tests/fake_dns.py``'s, written on each package's ``DnsOutcome``).
  The record holds every ``added``/``removed`` (key, backend) and every
  ``stateChanged`` with its virtual time, every query with its virtual
  time and options, and the inner machine's nameservers, counters, next
  refresh times and last error; the two records must be equal.
- The full stack over a scripted UDP nameserver on 127.0.0.1: each
  package's ``DNSResolver`` over its real ``DnsClient`` and socket.
"""

import asyncio
import copy
import random
import types

import pytest

pytest.importorskip('torch')

from cueball_tpu import dns_client as j_dc  # noqa: E402
from cueball_tpu import dns_resolver as j_dns  # noqa: E402
from cueball_tpu import netsim as j_netsim  # noqa: E402
from cueball_tpu import trace as j_trace  # noqa: E402
from cueball_tpu import utils as j_utils  # noqa: E402
from cueball_tpu import wiretap as j_wiretap  # noqa: E402
from cueball_tpu_torch import dns_client as t_dc  # noqa: E402
from cueball_tpu_torch import dns_resolver as t_dns  # noqa: E402
from cueball_tpu_torch import netsim as t_netsim  # noqa: E402
from cueball_tpu_torch import trace as t_trace  # noqa: E402
from cueball_tpu_torch import utils as t_utils  # noqa: E402
from cueball_tpu_torch import wiretap as t_wiretap  # noqa: E402
from cueball_tpu_torch.examples.discovered_fleet import (  # noqa: E402
    Nameserver)

from fake_dns import Cfg as FakeCfg, FakeDnsClient  # noqa: E402

JAX = types.SimpleNamespace(dc=j_dc, dns=j_dns, netsim=j_netsim,
                            utils=j_utils)
PORT = types.SimpleNamespace(dc=t_dc, dns=t_dns, netsim=t_netsim,
                             utils=t_utils)
RECOVERY = {'default': {'timeout': 1000, 'retries': 3, 'delay': 100}}
SEED = 5


@pytest.fixture(autouse=True)
def isolated():
    """Each test starts with both packages' claim tracers and wire
    ledgers off (one left on by another test would draw from the seeded
    RNG and count into the records) and with empty class-wide registries
    of DNS bootstrap resolvers and nameserver clients, which are put
    back after it: a bootstrap resolver left registered under a name
    would be reused by the next resolver that names it."""
    for trace, wiretap in ((j_trace, j_wiretap), (t_trace, t_wiretap)):
        trace.disable_tracing()
        wiretap.disable_wiretap()
    saved = [(fsm, fsm.bootstrap_resolvers, fsm.global_ns_clients)
             for fsm in (j_dns.DNSResolverFSM, t_dns.DNSResolverFSM)]
    for fsm, _boot, _clients in saved:
        fsm.bootstrap_resolvers, fsm.global_ns_clients = {}, {}
    yield
    for fsm, boot, clients in saved:
        fsm.bootstrap_resolvers, fsm.global_ns_clients = boot, clients


# -- the convention table of tests/fake_dns.py, on either package -----------

def _rr(name, rtype, ttl, target, port=None):
    return {'name': name, 'type': rtype, 'ttl': ttl, 'target': target,
            'port': port}


def _is_srv(parts, qtype):
    return len(parts) > 2 and parts[2] in ('_tcp', '_udp') and \
        qtype == 'SRV'


def convention(outcome, cfg, opts):
    """``tests/fake_dns.py``'s answer to ``opts``, as an ``outcome``
    (a package's ``DnsOutcome``), under ``cfg`` (its ``Cfg`` fields)."""
    domain, qtype = opts['domain'], opts['type']
    parts = domain.split('.')[::-1]
    answers, authority = [], []
    tld = parts[0]
    if cfg.srv_refuse and qtype == 'SRV':
        return outcome(rcode='SERVFAIL')
    if tld == 'ok':
        if parts[1] == 'srv' and _is_srv(parts, qtype):
            answers.append(_rr(domain, 'SRV', cfg.srv_ttl, 'a.ok', 111))
            answers.append(_rr(domain, 'SRV', cfg.srv_ttl, 'aaaa.ok', 111))
            if cfg.use_a2:
                answers.append(_rr(domain, 'SRV', cfg.srv_ttl, 'a2.ok',
                                   111))
        elif parts[1] == 'dupe' and _is_srv(parts, qtype):
            answers.append(_rr(domain, 'SRV', cfg.srv_ttl, 'dupe.ok', 112))
            if cfg.use_a2:
                answers.append(_rr(domain, 'SRV', cfg.srv_ttl, 'dupe.ok',
                                   112))
        elif parts[1] == 'a' and qtype == 'A':
            answers.append(_rr(domain, 'A', 3600, '1.2.3.4'))
        elif parts[1] == 'a2' and qtype == 'A':
            answers.append(_rr(domain, 'A', 3600, '1.2.3.5'))
        elif parts[1] == 'a2' and qtype == 'AAAA':
            answers.append(_rr(domain, 'AAAA', 1, '1234:abcd::2'))
        elif parts[1] == 'aaaa' and qtype == 'AAAA':
            answers.append(_rr(domain, 'AAAA', 3600, '1234:abcd::1'))
        elif parts[1] == 'dupe' and qtype == 'A':
            for _ in range(3):
                answers.append(_rr(domain, 'A', 3600, '1.2.3.1'))
        elif parts[1] in ('a', 'aaaa', 'a2', 'dupe'):
            pass  # NODATA
        else:
            return outcome(rcode='NXDOMAIN')
    elif tld == 'notfound':
        return outcome(rcode='NXDOMAIN')
    elif tld == 'notimp':
        if parts[1] == 'srv' and _is_srv(parts, qtype):
            answers.append(_rr(domain, 'SRV', 3600, 'a.notimp', 111))
        else:
            return outcome(rcode='NOTIMP')
    elif tld == 'short-ttl':
        if parts[1] == 'a' and qtype == 'A':
            answers.append(_rr(domain, 'A', 1, '1.2.3.4'))
        else:
            return outcome(rcode='NXDOMAIN')
    elif tld == 'soa-ttl':
        if parts[1] == 'a' and qtype == 'A':
            answers.append(_rr(domain, 'A', 3600, '1.2.3.9'))
        else:
            authority.append(_rr(domain, 'SOA', 17, None))
    elif tld == 'flaky':
        if parts[1] == 'srv' and _is_srv(parts, qtype):
            answers.append(_rr(domain, 'SRV', cfg.srv_ttl, 'host.flaky',
                               113))
        elif parts[1] == 'host' and cfg.flaky_fails.get(qtype, 0) > 0:
            cfg.flaky_fails[qtype] -= 1
            return outcome(rcode='SERVFAIL')
        elif parts[1] == 'host' and qtype == 'AAAA':
            answers.append(_rr(domain, 'AAAA', 3600, 'fd00::5'))
        elif parts[1] == 'host' and qtype == 'A':
            answers.append(_rr(domain, 'A', 3600, '1.2.3.7'))
        else:
            return outcome(rcode='NXDOMAIN')
    elif tld == 'refused':
        if parts[1] == 'srv' and _is_srv(parts, qtype):
            answers.append(_rr(domain, 'SRV', cfg.srv_ttl, 'host.refused',
                               114))
        elif parts[1] == 'host' and qtype == 'AAAA':
            return outcome(rcode='REFUSED')
        elif parts[1] == 'host' and qtype == 'A':
            answers.append(_rr(domain, 'A', 3600, '1.2.3.8'))
        else:
            return outcome(rcode='NXDOMAIN')
    elif tld == 'srvref':
        if qtype == 'SRV':
            return outcome(rcode='REFUSED')
        elif parts[1] == 'srv' and qtype == 'A':
            answers.append(_rr(domain, 'A', 3600, '1.2.3.21'))
        elif parts[1] == 'srv' and qtype == 'AAAA':
            pass  # NODATA
        else:
            return outcome(rcode='NXDOMAIN')
    elif tld == 'addl':
        if parts[1] == 'srv' and _is_srv(parts, qtype):
            answers.append(_rr(domain, 'SRV', cfg.srv_ttl, 'host.addl',
                               115))
            return outcome(answers=answers, additionals=[
                _rr('host.addl', 'A', 3600, '1.2.3.11'),
                _rr('host.addl', 'AAAA', 3600, 'fd00::11'),
            ])
        return outcome(rcode='NXDOMAIN')
    elif tld == 'timeout':
        return outcome(timeout=True)
    else:
        raise RuntimeError('wat: %s' % domain)
    return outcome(answers=answers, authority=authority)


def new_cfg(**kw):
    cfg = types.SimpleNamespace(use_a2=False, srv_ttl=3600, flaky_fails={},
                                srv_refuse=False)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _outcome_fields(out):
    return (out.answers, out.authority, out.additionals, out.rcode,
            out.delay_ms, out.timeout)


QUERIES = [(d, t) for d in (
    '_foo._tcp.srv.ok', '_foo._tcp.dupe.ok', 'a.ok', 'a2.ok', 'aaaa.ok',
    'dupe.ok', 'x.ok', 'foo.notfound', '_foo._tcp.srv.notimp', 'a.notimp',
    'a.short-ttl', 'b.short-ttl', 'a.soa-ttl', '_foo._tcp.srv.flaky',
    'host.flaky', '_foo._tcp.srv.refused', 'host.refused',
    '_foo._tcp.srv.srvref', 'srv.srvref', '_foo._tcp.srv.addl', 'x.timeout')
    for t in ('SRV', 'A', 'AAAA')]


@pytest.mark.parametrize('use_a2,flaky', [(False, {}), (True, {'A': 1}),
                                          (False, {'AAAA': 2})])
def test_convention_table_is_fake_dns(use_a2, flaky):
    """The copy above answers every query as ``tests/fake_dns.py``
    does, on both packages' ``DnsOutcome``."""
    saved = (FakeCfg.use_a2, FakeCfg.srv_ttl, FakeCfg.flaky_fails,
             FakeCfg.srv_refuse)
    FakeCfg.use_a2, FakeCfg.srv_ttl = use_a2, 7
    FakeCfg.flaky_fails, FakeCfg.srv_refuse = dict(flaky), False
    cfg = new_cfg(use_a2=use_a2, srv_ttl=7, flaky_fails=dict(flaky))
    port_cfg = new_cfg(use_a2=use_a2, srv_ttl=7, flaky_fails=dict(flaky))
    try:
        fake = FakeDnsClient()
        for domain, qtype in QUERIES * 2:
            opts = {'domain': domain, 'type': qtype}
            want = _outcome_fields(fake.script(opts))
            assert _outcome_fields(convention(
                j_netsim.DnsOutcome, cfg, opts)) == want
            assert _outcome_fields(convention(
                t_netsim.DnsOutcome, port_cfg, opts)) == want
    finally:
        (FakeCfg.use_a2, FakeCfg.srv_ttl, FakeCfg.flaky_fails,
         FakeCfg.srv_refuse) = saved
        FakeDnsClient.instances = []


# -- the wire codec ---------------------------------------------------------

def _names(rng, n):
    labels = ['svc', 'b0', 'fleet', 'test', 'example', 'com', '_http',
              '_tcp', 'xn--bcher-kva', 'a' * 63, 'ns1']
    return ['.'.join(rng.choice(labels) for _ in range(rng.randint(1, 5)))
            for _ in range(n)]


def _message(msg):
    return (msg.qid, msg.rcode, msg.tc, msg.get_answers(),
            msg.get_authority(), msg.get_additionals())


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_codec_matches_jax(seed):
    """Queries (with and without EDNS) encode to the same bytes, and
    responses of every record type encode and parse to the same
    messages, on seeded names and types."""
    rng = random.Random(seed)
    for name in _names(rng, 40):
        qtype = rng.choice(['A', 'AAAA', 'SRV'])
        qid = rng.randrange(1 << 16)
        size = rng.choice([None, j_dc.EDNS_UDP_SIZE])
        q = j_dc.build_query(qid, name, qtype, edns_size=size)
        assert t_dc.build_query(qid, name, qtype, edns_size=size) == q
        assert t_netsim.parse_query(q) == j_netsim.parse_query(q)
        answers = []
        for _ in range(rng.randint(0, 4)):
            rtype = rng.choice(['A', 'AAAA', 'SRV'])
            target = {'A': '10.%d.%d.%d' % (rng.randrange(256),
                                            rng.randrange(256),
                                            rng.randrange(256)),
                      'AAAA': 'fd00::%x' % rng.randrange(1 << 16),
                      'SRV': rng.choice(_names(rng, 3))}[rtype]
            rr = _rr(name, rtype, rng.randrange(1, 86400), target,
                     rng.randrange(1, 65536) if rtype == 'SRV' else None)
            if rtype == 'SRV':
                rr.update(priority=rng.randrange(10),
                          weight=rng.randrange(100))
            answers.append(rr)
        authority = ([dict(_rr(name, 'SOA', 30, None), minimum=30)]
                     if not answers else [])
        rcode = rng.choice(['NOERROR', 'NXDOMAIN', 'SERVFAIL'])
        tc = rng.random() < 0.2
        wire = j_netsim.encode_response(qid, name, qtype, rcode=rcode,
                                        answers=answers,
                                        authority=authority, tc=tc)
        assert t_netsim.encode_response(
            qid, name, qtype, rcode=rcode, answers=answers,
            authority=authority, tc=tc) == wire
        assert _message(t_dc.parse_response(wire)) == \
            _message(j_dc.parse_response(wire))
        cut = wire[:max(13, len(wire) - 7)]
        errs = []
        for dc in (j_dc, t_dc):
            try:
                errs.append(_message(dc.parse_response(cut)))
            except Exception as e:
                errs.append((type(e).__name__, str(e)))
        assert errs[0] == errs[1]


def test_codec_errors_and_names_match_jax():
    """The error classes, the IDNA label encoding and the name decoder
    with compression pointers agree."""
    for name in ('bücher.example', 'a.b.c', ''):
        assert t_dc.encode_name(name) == j_dc.encode_name(name)
    with pytest.raises(ValueError) as j_err:
        j_dc.encode_name('a' * 64 + '.x')
    with pytest.raises(ValueError) as t_err:
        t_dc.encode_name('a' * 64 + '.x')
    assert str(t_err.value) == str(j_err.value)
    pkt = b'\x00' * 12 + b'\x03foo\x07example\x00' + b'\x03bar\xc0\x10'
    assert t_dc._decode_name(pkt, 25) == j_dc._decode_name(pkt, 25)
    errs = [[str(e) for e in (
        dc.MultiError([dc.DnsError('REFUSED', 'x', '1.1.1.1'),
                       dc.DnsTimeoutError('x', '2.2.2.2')]),
        dc.DnsError('SERVFAIL', 'x'), dc.DnsTimeoutError('y'))]
        for dc in (j_dc, t_dc)]
    assert errs[1] == errs[0]


# -- the resolver scenarios -------------------------------------------------

def _opts_record(opts):
    return sorted((k, v) for k, v in opts.items()
                  if isinstance(v, (str, int, float, list, type(None))))


def _inner_record(inner):
    err = inner.r_last_error
    return {
        'state': inner.get_state(),
        'resolvers': list(inner.r_resolvers),
        'counters': dict(inner.r_counters),
        'next': [getattr(inner, 'r_next_service', None),
                 getattr(inner, 'r_next_v6', None),
                 getattr(inner, 'r_next_v4', None)],
        'seen': [inner.r_have_seen_srv, inner.r_have_seen_addr],
        'backends': dict(inner.r_backends),
        'last_error': None if err is None else (type(err).__name__,
                                                str(err)),
    }


def drive(pkg, domain, seconds, cfg=None, v6=True, changes=(), **opts):
    """Run one resolver scenario over ``pkg``: start a ``DNSResolver``
    for ``domain`` over a scripted client, apply each of ``changes``
    (``(t, fn(cfg, resolver, pkg))``) at virtual second ``t``, stop at
    ``seconds``. Returns the record."""
    cfg = cfg or new_cfg()
    pkg.dns.DNSResolverFSM.bootstrap_resolvers = {}
    pkg.dns.DNSResolverFSM.global_ns_clients = {}
    saved = pkg.dns.have_global_v6
    pkg.dns.have_global_v6 = lambda: v6

    async def main():
        loop = asyncio.get_running_loop()
        queries = []

        def script(q):
            queries.append((loop.time(), _opts_record(q)))
            return convention(pkg.netsim.DnsOutcome, cfg, q)

        client = pkg.netsim.ScriptedDnsClient(script)
        res = pkg.dns.DNSResolver(dict({
            'domain': domain, 'service': '_foo._tcp', 'defaultPort': 112,
            'resolvers': ['1.2.3.4'], 'recovery': RECOVERY,
            'dnsClient': client}, **opts))
        events = []
        res.on('added', lambda k, b: events.append(
            (loop.time(), 'added', k, dict(b))))
        res.on('removed', lambda k: events.append(
            (loop.time(), 'removed', k)))
        res.on('stateChanged', lambda s: events.append(
            (loop.time(), 'state', s)))
        res.start()
        marks = []
        for t, change in changes:
            await asyncio.sleep(max(t - loop.time(), 0))
            change(cfg, res, pkg)
            marks.append(_inner_record(res.r_fsm))
        await asyncio.sleep(max(seconds - loop.time(), 0))
        rec = {'events': events, 'queries': queries, 'marks': marks,
               'inner': _inner_record(res.r_fsm), 'count': res.count(),
               'list': res.list(), 'state': res.get_state()}
        res.stop()
        while not res.is_in_state('stopped'):
            await asyncio.sleep(0.01)
        rec['stopped_at'] = loop.time()
        return rec

    try:
        return pkg.netsim.run(main(), seed=SEED)
    finally:
        pkg.dns.have_global_v6 = saved


def both(domain, seconds, cfg, *args, **kw):
    """The scenario over the JAX package, then over the port, each from
    its own copy of ``cfg``; asserts the records are equal and returns
    the port's."""
    want = drive(JAX, domain, seconds, copy.deepcopy(cfg), *args, **kw)
    got = drive(PORT, domain, seconds, copy.deepcopy(cfg), *args, **kw)
    assert got == want
    return got


def _force_srv_due(cfg, res, pkg):
    res.r_fsm.r_next_service = pkg.utils.wall_time() - 1


def _set(**kw):
    def change(cfg, res, pkg):
        for k, v in kw.items():
            setattr(cfg, k, v)
    return change


SCENARIOS = {
    # name: (domain, seconds, cfg fields, v6, changes, resolver options)
    'srv_lookup': ('srv.ok', 2.0, {}, True, (), {}),
    'plain_a_lookup': ('a.ok', 2.0, {}, True, (), {}),
    'not_found_fails': ('foo.notfound', 10.0, {}, True, (), {}),
    'notimp_fails': ('a.notimp', 10.0, {}, True, (), {}),
    'srv_ok_notimp_addresses_fails': ('srv.notimp', 10.0, {}, True, (), {}),
    'short_ttl_requeries_only_expired_stage': (
        'a.short-ttl', 4.0, {}, True, (), {}),
    'no_ipv6_shortcut': ('a.ok', 2.0, {}, False, (), {}),
    'duped_records_dedup': ('srv.dupe.ok', 2.0, {'use_a2': True}, True,
                            (), {}),
    'soa_ttl_nodata': ('a.soa-ttl', 40.0, {}, True, (), {}),
    'timeout_then_failure': ('x.timeout', 10.0, {}, True, (), {
        'recovery': {'default': {'timeout': 100, 'retries': 2,
                                 'delay': 20}}}),
    'srv_record_change_emits_removed_added': (
        'srv.ok', 6.0, {'srv_ttl': 1}, True,
        ((1.0, _set(use_a2=True)), (3.5, _set(use_a2=False))), {}),
    'srv_only_services_expire': (
        'srv.ok', 3.0, {'srv_ttl': 1}, True,
        ((0.5, _set(use_a2=True)),), {}),
    'aaaa_error_retry_ladder': ('srv.flaky', 3.0,
                                {'flaky_fails': {'AAAA': 2}}, True, (), {}),
    'a_error_retries_exhausted_keeps_v6': (
        'srv.flaky', 3.0, {'flaky_fails': {'A': 99}}, True, (), {}),
    'aaaa_refused_fast_fails_to_a': ('srv.refused', 2.0, {}, True, (), {}),
    'srv_refused_falls_through_to_a': ('srv.srvref', 2.0, {}, True, (), {}),
    'srv_additionals_skip_address_lookups': ('srv.addl', 2.0, {}, True, (),
                                             {}),
    'srv_antiflap_15min_fallback': (
        'a.short-ttl', 6.0, {'srv_refuse': True}, True,
        ((0.5, _force_srv_due),), {
            'recovery': {'default': {'timeout': 200, 'retries': 2,
                                     'delay': 20}}}),
    'bootstrap_dynamic_resolver_mode': ('a.ok', 3.0, {}, True, (),
                                        {'resolvers': ['srv.ok']}),
    'bootstrap_ns_topology_changes_propagate': (
        'a.ok', 6.0, {'use_a2': True, 'srv_ttl': 1}, True,
        ((1.0, _set(use_a2=False)),), {'resolvers': ['srv.ok']}),
}


@pytest.mark.parametrize('name', sorted(SCENARIOS))
def test_resolver_scenario_matches_jax(name):
    domain, seconds, fields, v6, changes, opts = SCENARIOS[name]
    rec = both(domain, seconds, new_cfg(**fields), v6, changes, **opts)
    assert rec['queries']
    if name in ('srv_lookup', 'srv_record_change_emits_removed_added',
                'bootstrap_dynamic_resolver_mode'):
        assert rec['count'] >= 1 and rec['state'] == 'running'


def test_scenarios_differ_where_the_zone_does():
    """The records are not trivially equal: a changed zone changes
    them (a guard against comparing two empty runs)."""
    a = drive(PORT, 'srv.ok', 2.0, new_cfg())
    b = drive(PORT, 'srv.ok', 2.0, new_cfg(use_a2=True))
    assert a != b and len(b['list']) == len(a['list']) + 2


def test_bootstrap_teardown_refcounting_matches_jax():
    """Two resolvers share one refcounted bootstrap; each stop
    decrements it, the last one stops it: the same counts and states,
    at the same virtual times, in both packages."""
    def run(pkg):
        pkg.dns.DNSResolverFSM.bootstrap_resolvers = {}
        saved = pkg.dns.have_global_v6
        pkg.dns.have_global_v6 = lambda: True

        async def main():
            loop = asyncio.get_running_loop()
            client = pkg.netsim.ScriptedDnsClient(
                lambda q: convention(pkg.netsim.DnsOutcome, new_cfg(), q))

            def mk():
                return pkg.dns.DNSResolver({
                    'domain': 'a.ok', 'service': '_foo._tcp',
                    'defaultPort': 112, 'resolvers': ['srv.ok'],
                    'recovery': RECOVERY, 'dnsClient': client})

            async def until(fsm, state):
                while not fsm.is_in_state(state):
                    await asyncio.sleep(0.01)
                return loop.time()

            r1, r2 = mk(), mk()
            rec = []
            r1.start()
            rec.append(await until(r1, 'running'))
            r2.start()
            rec.append(await until(r2, 'running'))
            boot = r1.r_fsm.r_bootstrap
            rec.append((boot is r2.r_fsm.r_bootstrap, boot.r_ref_count,
                        len(pkg.dns.DNSResolverFSM.bootstrap_resolvers)))
            r1.stop()
            rec.append(await until(r1, 'stopped'))
            rec.append((boot.r_ref_count, boot.get_state()))
            r2.stop()
            rec.append(await until(r2, 'stopped'))
            rec.append(await until(boot, 'init'))
            rec.append((boot.r_ref_count,
                        [(q['domain'], q['type']) for q in client.history]))
            return rec
        try:
            return pkg.netsim.run(main(), seed=SEED)
        finally:
            pkg.dns.have_global_v6 = saved

    want = run(JAX)
    assert run(PORT) == want
    assert want[2] == (True, 2, 1) and want[-1][0] == 0


def _one_request(pkg, client_cls, qtype):
    """A single ``resolve()`` request of the inner machine over a client
    of ``client_cls(pkg)``: the events it emitted and the counters."""
    pkg.dns.have_global_v6, saved = (lambda: True), pkg.dns.have_global_v6

    async def main():
        res = pkg.dns.DNSResolver({
            'domain': 'whatever.ok', 'service': '_foo._tcp',
            'defaultPort': 112, 'resolvers': ['1.2.3.4'],
            'recovery': RECOVERY, 'dnsClient': client_cls(pkg)})
        inner = res.r_fsm
        req = inner.resolve('x.example', qtype, 1000)
        got = []
        req.on('error', lambda err: got.append(
            ('error', type(err).__name__, getattr(err, 'code', None),
             str(err))))
        req.on('answers', lambda ans, ttl: got.append(('answers', ans, ttl)))
        req.send()
        await asyncio.sleep(0.05)
        return got, dict(inner.r_counters)
    try:
        return pkg.netsim.run(main(), seed=SEED)
    finally:
        pkg.dns.have_global_v6 = saved


def _voting_client(pkg):
    dc = pkg.dc

    class VotingClient:
        def lookup(self, opts, cb):
            err = dc.MultiError([
                dc.DnsError('REFUSED', opts['domain'], '1.1.1.1'),
                dc.DnsError('REFUSED', opts['domain'], '2.2.2.2'),
                dc.DnsError('SERVFAIL', opts['domain'], '3.3.3.3'),
                dc.DnsTimeoutError(opts['domain'], '4.4.4.4'),
            ])
            asyncio.get_running_loop().call_soon(cb, err, None)
    return VotingClient()


def _cname_client(pkg):
    dc = pkg.dc

    class CnameClient:
        def lookup(self, opts, cb):
            answers = [] if opts['type'] != 'A' else [
                {'name': opts['domain'], 'type': 'CNAME', 'ttl': 60,
                 'target': 'real.example', 'port': None},
                {'name': 'real.example', 'type': 'A', 'ttl': 60,
                 'target': '9.9.9.9', 'port': None}]
            msg = dc.DnsMessage(1, 'NOERROR', False, answers, [], [])
            asyncio.get_running_loop().call_soon(cb, None, msg)
    return CnameClient()


@pytest.mark.parametrize('client,qtype', [(_voting_client, 'A'),
                                          (_cname_client, 'A'),
                                          (_cname_client, 'AAAA')])
def test_single_request_policy_matches_jax(client, qtype):
    """Multi-resolver rcode voting and CNAME skipping: the same events
    and counters."""
    want = _one_request(JAX, client, qtype)
    assert _one_request(PORT, client, qtype) == want
    assert want[0]


def test_resolv_conf_parsing_matches_jax(tmp_path):
    p = tmp_path / 'resolv.conf'
    p.write_text('# comment\nsearch example.com\nnameserver 10.0.0.53\n'
                 '  nameserver   fd00::53  \nnameserver not-an-ip\n')
    empty = tmp_path / 'empty.conf'
    empty.write_text('search example.com\n')
    for path in (p, empty, tmp_path / 'missing'):
        assert t_dns._read_resolv_conf(str(path)) == \
            j_dns._read_resolv_conf(str(path))
    assert t_dns._read_resolv_conf(str(p)) == ['10.0.0.53', 'fd00::53']


@pytest.mark.parametrize('bad', [
    'not-a-dict',
    {'domain': 42, 'recovery': RECOVERY},
    {'domain': 'x.example', 'recovery': RECOVERY, 'resolvers': '1.2.3.4'},
    {'domain': 'x.example', 'recovery': RECOVERY, 'resolvers': [1, 2]},
    {'domain': 'x.example'},
    {'domain': 'x.example', 'recovery': {'default': {
        'retries': 1, 'timeout': 100, 'delay': 10, 'bogusKey': 1}}},
])
def test_ctor_validation_matches_jax(bad):
    with pytest.raises(AssertionError) as j_err:
        j_dns.DNSResolver(bad)
    with pytest.raises(AssertionError) as t_err:
        t_dns.DNSResolver(bad)
    assert str(t_err.value) == str(j_err.value)


# -- the full stack over a UDP nameserver -----------------------------------

def test_full_stack_over_udp_matches_jax():
    """Each package's ``DNSResolver`` over its real ``DnsClient`` and a
    UDP socket, against one nameserver on 127.0.0.1 serving the port's
    ``SimZone``: the same backends, keys and queries. Each package reads
    a netsim clock that never moves, so the TTL arithmetic behind the
    ``max-sleep`` counter does not see the real milliseconds the run
    takes."""
    zone = t_netsim.SimZone()
    zone.add_srv_backend('_svc._tcp.svc.test', 'backend.svc.test', 8080,
                         '10.1.2.3', ttl=3600, addr_ttl=3600)
    zone.add_srv_backend('_svc._tcp.svc.test', 'other.svc.test', 8081,
                         '10.1.2.4', ttl=3600, addr_ttl=3600)

    def run(pkg):
        saved = pkg.dns.have_global_v6
        pkg.dns.have_global_v6 = lambda: False
        saved_clock = pkg.utils.set_clock(pkg.netsim.VirtualClock())

        async def main():
            loop = asyncio.get_running_loop()
            transport, ns = await loop.create_datagram_endpoint(
                lambda: Nameserver(zone), local_addr=('127.0.0.1', 0))
            port = transport.get_extra_info('sockname')[1]
            res = pkg.dns.DNSResolver({
                'domain': 'svc.test', 'service': '_svc._tcp',
                'resolvers': ['127.0.0.1@%d' % port],
                'recovery': {'default': {'timeout': 1000, 'retries': 2,
                                         'delay': 50}}})
            added = []
            res.on('added', lambda k, b: added.append((k, dict(b))))
            res.start()
            try:
                while not res.is_in_state('running'):
                    await asyncio.sleep(0.005)
                res.stop()
                while not res.is_in_state('stopped'):
                    await asyncio.sleep(0.005)
            finally:
                transport.close()
            return sorted(added), dict(ns.answered), \
                dict(res.r_fsm.r_counters)
        try:
            return asyncio.run(asyncio.wait_for(main(), 20))
        finally:
            pkg.utils.set_clock(saved_clock)
            pkg.dns.have_global_v6 = saved

    want = run(JAX)
    got = run(PORT)
    assert got == want
    assert [b['address'] for _k, b in got[0]] == ['10.1.2.3', '10.1.2.4'] \
        or sorted(b['address'] for _k, b in got[0]) == ['10.1.2.3',
                                                        '10.1.2.4']
    assert got[1] == {'SRV': 1, 'A': 2}
