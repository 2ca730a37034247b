"""Scriptable DNS for netsim: zones, chaos clients, middleboxes.

Three integration levels, lowest fidelity first:

- ``ScriptedDnsClient``: plugs in as ``options['dnsClient']`` on a
  DNSResolver and answers from a script function, one outcome object
  per query. The per-case fakes the suite grew organically
  (tests/fake_dns.py, the soak chaos client) are thin shims over the
  JAX package's copy of this module.
- ``ChaosDnsClient``: a ScriptedDnsClient whose outcomes are drawn
  from a seeded rng over a weighted band table — answers with short
  TTLs, NXDOMAIN/NODATA/NOTIMP/REFUSED/SERVFAIL, timeouts.
- ``SimWire``: a ``dns_client.DnsTransport`` middlebox. The REAL
  DnsClient encodes queries; SimWire parses them, consults a
  ``SimZone``, and encodes wire-format responses — optionally
  misbehaving per resolver (FORMERR on EDNS, TC-bit truncation,
  cut-off packets, SERVFAIL, blackholes). This exercises the
  _query_wire failure branches (EDNS fallback, TC->TCP retry,
  malformed-packet handling, shared deadlines) that no socket-free
  test could reach before.

All delays are asyncio timers, so under a VirtualLoop they cost no
wall time; all randomness comes from an injected rng. See
docs/netsim.md.
"""

from __future__ import annotations

import asyncio
import ipaddress
import struct

from ..dns_client import (CLASS_IN, TYPE_CODES, TYPE_NAMES, DnsError,
                          DnsMessage, DnsTimeoutError, DnsTransport,
                          _decode_name, encode_name)


def _rr(name, rtype, ttl, target, port=None, priority=0, weight=10):
    rr = {'name': name, 'type': rtype, 'ttl': ttl, 'target': target,
          'port': port}
    if rtype == 'SRV':
        rr['priority'] = priority
        rr['weight'] = weight
    return rr


class DnsOutcome:
    """One query's scripted result. ``rcode`` other than NOERROR is
    delivered as a DnsError; ``timeout`` waits out the query budget
    and delivers DnsTimeoutError; ``delay_ms`` defers delivery on the
    (virtual) loop."""

    def __init__(self, answers=None, authority=None, additionals=None,
                 rcode: str = 'NOERROR', delay_ms: float = 0.0,
                 timeout: bool = False):
        self.answers = list(answers or [])
        self.authority = list(authority or [])
        self.additionals = list(additionals or [])
        self.rcode = rcode
        self.delay_ms = delay_ms
        self.timeout = timeout


class ScriptedDnsClient:
    """DnsClient-shaped object (lookup(opts, cb)) answering from a
    script: ``script(opts) -> DnsOutcome``. Records every opts dict in
    ``history`` for exact-sequence assertions, like the legacy
    tests/fake_dns.py surface of the JAX package's suite."""

    def __init__(self, script=None):
        self.history: list[dict] = []
        if script is not None:
            self.script = script

    def script(self, opts: dict) -> DnsOutcome:
        raise NotImplementedError(
            'pass script= or subclass ScriptedDnsClient')

    def lookup(self, opts: dict, cb) -> None:
        loop = asyncio.get_running_loop()
        self.history.append(opts)
        out = self.script(opts)
        domain = opts['domain']
        if out.timeout:
            loop.call_later(opts.get('timeout', 5000) / 1000.0, cb,
                            DnsTimeoutError(domain), None)
            return
        msg = DnsMessage(1234, 'NOERROR', False, out.answers,
                         out.authority, out.additionals)
        err = None
        if out.rcode != 'NOERROR':
            err = DnsError(out.rcode, domain)
        if out.delay_ms > 0:
            loop.call_later(out.delay_ms / 1000.0, cb, err, msg)
        else:
            loop.call_soon(cb, err, msg)


# Default outcome distribution for ChaosDnsClient: cumulative
# probability bands over the rcode policy matrix, mirroring the soak
# distribution the resolver chaos test established.
CHAOS_BANDS = (
    (0.50, 'answer'),
    (0.62, 'NXDOMAIN'),
    (0.72, 'nodata'),
    (0.79, 'NOTIMP'),
    (0.86, 'REFUSED'),
    (0.93, 'SERVFAIL'),
    (1.01, 'timeout'),
)


class ChaosDnsClient(ScriptedDnsClient):
    """Seeded random outcomes over the full rcode policy matrix.
    Answers use ``ttl``-second TTLs (default 1) so the resolver's
    sleep state re-queries continuously."""

    def __init__(self, rng, bands=CHAOS_BANDS, ttl: int = 1):
        super().__init__()
        self.rng = rng
        self.bands = bands
        self.ttl = ttl
        self.queries = 0

    def script(self, opts: dict) -> DnsOutcome:
        self.queries += 1
        domain, qtype = opts['domain'], opts['type']
        roll = self.rng.random()
        kind = next(k for ceil, k in self.bands if roll < ceil)
        if kind == 'answer':
            answers = []
            if qtype == 'SRV':
                for i in range(self.rng.randint(1, 3)):
                    answers.append(_rr(domain, 'SRV', self.ttl,
                                       't%d.chaos' % i, 100 + i))
            elif qtype == 'A':
                for i in range(self.rng.randint(1, 2)):
                    answers.append(_rr(domain, 'A', self.ttl,
                                       '10.0.0.%d' % (1 + i)))
            elif qtype == 'AAAA' and self.rng.random() < 0.5:
                answers.append(_rr(domain, 'AAAA', self.ttl, 'fd00::1'))
            return DnsOutcome(answers=answers)
        if kind == 'nodata':
            authority = []
            if self.rng.random() < 0.5:
                authority.append(_rr(domain, 'SOA', self.ttl, None))
            return DnsOutcome(authority=authority)
        if kind == 'timeout':
            return DnsOutcome(timeout=True)
        return DnsOutcome(rcode=kind)


# ---------------------------------------------------------------------------
# Authoritative zone data

class SimZone:
    """Mutable authoritative record store. Distinguishes NXDOMAIN
    (never-seen name) from NODATA (known name, no records of the
    queried type), the distinction the resolver's policy matrix keys
    on. Mutate mid-run (set_records / remove) to model flapping."""

    def __init__(self, soa_minimum: int = 5):
        self._records: dict[tuple[str, str], list[dict]] = {}
        self._names: set[str] = set()
        self.soa_minimum = soa_minimum

    @staticmethod
    def _key(domain: str, qtype: str) -> tuple[str, str]:
        return (domain.rstrip('.').lower(), qtype.upper())

    def add(self, domain: str, qtype: str, target, ttl: int = 60,
            port: int | None = None, priority: int = 0,
            weight: int = 10) -> None:
        key = self._key(domain, qtype)
        self._names.add(key[0])
        self._records.setdefault(key, []).append(
            _rr(key[0], key[1], ttl, target, port, priority, weight))

    def add_srv_backend(self, service: str, target: str, port: int,
                        address: str, ttl: int = 60,
                        addr_ttl: int = 60) -> None:
        """One backend = one SRV record plus its address record."""
        self.add(service, 'SRV', target, ttl=ttl, port=port)
        rtype = 'AAAA' if ':' in address else 'A'
        self.add(target, rtype, address, ttl=addr_ttl)

    def set_records(self, domain: str, qtype: str,
                    records: list[dict]) -> None:
        key = self._key(domain, qtype)
        self._names.add(key[0])
        self._records[key] = list(records)

    def remove(self, domain: str, qtype: str | None = None) -> None:
        """Drop records; the name stays known (NODATA, not NXDOMAIN)."""
        name = domain.rstrip('.').lower()
        for key in list(self._records):
            if key[0] == name and qtype in (None, key[1]):
                del self._records[key]

    def forget(self, domain: str) -> None:
        """Drop the name entirely: subsequent queries see NXDOMAIN."""
        self.remove(domain)
        self._names.discard(domain.rstrip('.').lower())

    def resolve(self, domain: str, qtype: str) \
            -> tuple[str, list[dict], list[dict]]:
        """-> (rcode, answers, authority)."""
        key = self._key(domain, qtype)
        if key[0] not in self._names:
            return 'NXDOMAIN', [], []
        answers = list(self._records.get(key) or [])
        if answers:
            return 'NOERROR', answers, []
        soa = _rr(key[0], 'SOA', self.soa_minimum, None)
        soa['minimum'] = self.soa_minimum
        return 'NOERROR', [], [soa]


# ---------------------------------------------------------------------------
# Wire codec for the middlebox transport

def parse_query(payload: bytes) -> tuple[int, str, str, bool]:
    """-> (qid, domain, qtype, has_edns_opt) from an encoded query."""
    qid, _flags, qd, _an, _ns, ar = struct.unpack('>HHHHHH',
                                                  payload[:12])
    if qd != 1:
        raise ValueError('expected exactly one question')
    domain, off = _decode_name(payload, 12)
    qtype_code, _qclass = struct.unpack('>HH', payload[off:off + 4])
    qtype = TYPE_NAMES.get(qtype_code, str(qtype_code))
    return qid, domain, qtype, ar > 0


_RCODE_CODES = {'NOERROR': 0, 'FORMERR': 1, 'SERVFAIL': 2,
                'NXDOMAIN': 3, 'NOTIMP': 4, 'REFUSED': 5}


def _encode_rdata(rr: dict) -> bytes:
    rtype = rr['type']
    if rtype == 'A':
        return bytes(int(b) for b in rr['target'].split('.'))
    if rtype == 'AAAA':
        return ipaddress.IPv6Address(rr['target']).packed
    if rtype == 'SRV':
        return struct.pack('>HHH', rr.get('priority', 0),
                           rr.get('weight', 10), rr['port']) + \
            encode_name(rr['target'])
    if rtype == 'SOA':
        minimum = rr.get('minimum', rr.get('ttl', 5))
        return encode_name('ns.' + rr['name']) + \
            encode_name('hostmaster.' + rr['name']) + \
            struct.pack('>IIIII', 1, 3600, 600, 86400, minimum)
    raise ValueError('cannot encode rdata for type %r' % rtype)


def _encode_rr(rr: dict) -> bytes:
    rdata = _encode_rdata(rr)
    return encode_name(rr['name']) + struct.pack(
        '>HHIH', TYPE_CODES[rr['type']], CLASS_IN, rr['ttl'],
        len(rdata)) + rdata


def encode_response(qid: int, domain: str, qtype: str,
                    rcode: str = 'NOERROR', answers=None,
                    authority=None, additionals=None,
                    tc: bool = False) -> bytes:
    """Encode a wire-format response (uncompressed names) that
    dns_client.parse_response round-trips. Inverse of build_query —
    the encoder the repo never needed until responses had to be
    synthesized."""
    answers = list(answers or [])
    authority = list(authority or [])
    additionals = list(additionals or [])
    flags = 0x8000 | 0x0100 | _RCODE_CODES[rcode]  # QR | RD | rcode
    if tc:
        flags |= 0x0200
    header = struct.pack('>HHHHHH', qid, flags, 1, len(answers),
                         len(authority), len(additionals))
    question = encode_name(domain) + struct.pack(
        '>HH', TYPE_CODES[qtype], CLASS_IN)
    body = b''.join(_encode_rr(rr)
                    for rr in answers + authority + additionals)
    return header + question + body


class SimWire(DnsTransport):
    """Wire-level middlebox: serves a SimZone to the REAL DnsClient
    through the DnsTransport seam, with per-resolver misbehavior.

    ``behaviors`` maps a resolver host (the string DnsClient was given,
    sans port) to one of:

    - ``'ok'`` — answer from the zone (the default)
    - ``'formerr-edns'`` — FORMERR any query carrying an EDNS OPT;
      answer the plain-RFC1035 retry (legacy middlebox, RFC 6891 6.2.2)
    - ``'notimp-edns'`` — same but NOTIMP
    - ``'tc-udp'`` — set the TC bit and serve an empty answer section
      over UDP; serve fully over TCP (truncating middlebox)
    - ``'truncate'`` — cut the response bytes mid-record (malformed)
    - ``'servfail'`` — SERVFAIL everything
    - ``'blackhole'`` — never answer (the query times out)
    """

    def __init__(self, zone: SimZone, behaviors: dict | None = None,
                 latency_s: float = 0.001):
        self.zone = zone
        self.behaviors = dict(behaviors or {})
        self.latency_s = latency_s
        self.log: list[tuple] = []

    def _behavior(self, resolver: str) -> str:
        return self.behaviors.get(resolver, 'ok')

    def _answer(self, qid: int, domain: str, qtype: str,
                tc: bool = False, empty: bool = False) -> bytes:
        rcode, answers, authority = self.zone.resolve(domain, qtype)
        if empty:
            answers = []
        return encode_response(qid, domain, qtype, rcode=rcode,
                               answers=answers, authority=authority,
                               tc=tc)

    async def _common(self, proto: str, resolver: str, payload: bytes,
                      timeout_s: float) -> bytes:
        qid, domain, qtype, has_opt = parse_query(payload)
        behavior = self._behavior(resolver)
        self.log.append((proto, resolver, domain, qtype, behavior))
        if behavior == 'blackhole':
            await asyncio.sleep(timeout_s)
            raise asyncio.TimeoutError()
        await asyncio.sleep(self.latency_s)
        if behavior == 'servfail':
            return encode_response(qid, domain, qtype,
                                   rcode='SERVFAIL')
        if behavior in ('formerr-edns', 'notimp-edns') and has_opt:
            rcode = 'FORMERR' if behavior == 'formerr-edns' \
                else 'NOTIMP'
            return encode_response(qid, domain, qtype, rcode=rcode)
        if behavior == 'truncate':
            full = self._answer(qid, domain, qtype)
            return full[:max(13, len(full) - 7)]
        if behavior == 'tc-udp' and proto == 'udp':
            return self._answer(qid, domain, qtype, tc=True,
                                empty=True)
        return self._answer(qid, domain, qtype)

    async def udp(self, resolver: str, port: int, payload: bytes,
                  timeout_s: float) -> bytes:
        return await self._common('udp', resolver, payload, timeout_s)

    async def tcp(self, resolver: str, port: int, payload: bytes,
                  timeout_s: float) -> bytes:
        return await self._common('tcp', resolver, payload, timeout_s)
