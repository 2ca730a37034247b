"""Minimal DNS wire-protocol client (mname-client replacement).

The reference depends on Joyent's `mname-client` for DNS packet
encode/decode and resolver fan-out (reference lib/resolver.js:24,
385-392, 1210-1377). This is a from-scratch asyncio implementation of
the parts cueball uses:

- query encoding for SRV/AAAA/A lookups
- response parsing with name decompression, answers/authority/additionals
  sections, and the record types the resolver consumes
  (A, AAAA, SRV, SOA, CNAME/DNAME recognition, OPT skipping)
- EDNS(0): queries advertise a 1400 B UDP payload via an OPT
  pseudo-RR (RFC 6891), so fleet-sized SRV answer sets arrive in one
  datagram instead of eating a TC->TCP retry per refresh
- UDP transport with TCP fallback when the TC (truncation) bit is set
- multi-resolver fan-out with per-resolver error collection; when all
  resolvers fail the caller receives a MultiError whose parts carry the
  rcode, enabling the resolver's rcode-voting policy
  (reference lib/resolver.js:1227-1259).

Record objects are plain dicts with keys name/type/ttl/target/port,
matching what the resolver's answer-processing expects.
"""

from __future__ import annotations

import asyncio
import struct

from . import utils as mod_utils

# RR type codes
TYPE_A = 1
TYPE_CNAME = 5
TYPE_SOA = 6
TYPE_AAAA = 28
TYPE_SRV = 33
TYPE_OPT = 41
TYPE_DNAME = 39

TYPE_NAMES = {TYPE_A: 'A', TYPE_CNAME: 'CNAME', TYPE_SOA: 'SOA',
              TYPE_AAAA: 'AAAA', TYPE_SRV: 'SRV', TYPE_OPT: 'OPT',
              TYPE_DNAME: 'DNAME'}
TYPE_CODES = {v: k for k, v in TYPE_NAMES.items()}

RCODES = {0: 'NOERROR', 1: 'FORMERR', 2: 'SERVFAIL', 3: 'NXDOMAIN',
          4: 'NOTIMP', 5: 'REFUSED'}

CLASS_IN = 1


class DnsError(Exception):
    """Non-zero rcode from a nameserver; .code carries the rcode name."""

    def __init__(self, code: str, domain: str, resolver: str | None = None):
        self.code = code
        self.domain = domain
        self.resolver = resolver
        super().__init__('DNS error %s for %s%s' % (
            code, domain, ' from %s' % resolver if resolver else ''))


class DnsTimeoutError(Exception):
    """One resolver timed out. name attr mirrors mname-client's
    TimeoutError identification (reference lib/resolver.js:1235)."""

    name = 'TimeoutError'

    def __init__(self, domain: str, resolver: str | None = None):
        self.domain = domain
        self.resolver = resolver
        super().__init__('DNS timeout for %s%s' % (
            domain, ' from %s' % resolver if resolver else ''))


class MultiError(Exception):
    """All resolvers failed; parts available via errors()
    (verror MultiError analogue)."""

    name = 'MultiError'

    def __init__(self, errs: list):
        self._errs = errs
        super().__init__('all resolvers failed: %s' %
                         '; '.join(str(e) for e in errs))

    def errors(self) -> list:
        return list(self._errs)


# ---------------------------------------------------------------------------
# Wire encoding / decoding

def encode_name(name: str) -> bytes:
    out = b''
    for label in name.rstrip('.').split('.'):
        raw = label.encode('idna') if not label.isascii() else \
            label.encode()
        if len(raw) > 63:
            raise ValueError('DNS label too long: %r' % label)
        out += bytes([len(raw)]) + raw
    return out + b'\x00'


# EDNS(0) advertised UDP payload size (RFC 6891). The plain-DNS 512 B
# ceiling truncates the SRV answer set of any real fleet (~18 records)
# and costs a TCP retry per refresh; 1400 keeps the datagram under
# common path MTUs while fitting ~60 SRV records.
EDNS_UDP_SIZE = 1400


def build_query(qid: int, domain: str, qtype: str,
                edns_size: int | None = EDNS_UDP_SIZE) -> bytes:
    flags = 0x0100  # RD
    arcount = 0 if edns_size is None else 1
    header = struct.pack('>HHHHHH', qid, flags, 1, 0, 0, arcount)
    question = encode_name(domain) + struct.pack(
        '>HH', TYPE_CODES[qtype], CLASS_IN)
    if edns_size is None:
        return header + question
    # OPT pseudo-RR (RFC 6891 6.1.2): root name, TYPE=OPT, CLASS
    # carries the advertised UDP payload size, TTL carries extended
    # rcode/version/flags (all zero: EDNS version 0, no DO), no rdata.
    opt = b'\x00' + struct.pack('>HHIH', TYPE_OPT, edns_size, 0, 0)
    return header + question + opt


def _decode_name(data: bytes, off: int) -> tuple[str, int]:
    labels = []
    jumped = False
    end = off
    seen = set()
    while True:
        if off >= len(data):
            raise ValueError('truncated name')
        ln = data[off]
        if ln & 0xC0 == 0xC0:
            ptr = struct.unpack('>H', data[off:off + 2])[0] & 0x3FFF
            if not jumped:
                end = off + 2
                jumped = True
            if ptr in seen:
                raise ValueError('name compression loop')
            seen.add(ptr)
            off = ptr
            continue
        off += 1
        if ln == 0:
            break
        labels.append(data[off:off + ln].decode('ascii', 'replace'))
        off += ln
    if not jumped:
        end = off
    return '.'.join(labels), end


def _parse_rr(data: bytes, off: int) -> tuple[dict, int]:
    name, off = _decode_name(data, off)
    rtype, rclass, ttl, rdlen = struct.unpack(
        '>HHIH', data[off:off + 10])
    off += 10
    rdata = data[off:off + rdlen]
    rdstart = off
    off += rdlen

    rr = {'name': name, 'type': TYPE_NAMES.get(rtype, rtype),
          'ttl': ttl, 'target': None, 'port': None}
    if rtype == TYPE_A and rdlen == 4:
        rr['target'] = '.'.join(str(b) for b in rdata)
    elif rtype == TYPE_AAAA and rdlen == 16:
        import ipaddress
        rr['target'] = str(ipaddress.IPv6Address(rdata))
    elif rtype == TYPE_SRV:
        prio, weight, port = struct.unpack('>HHH', rdata[:6])
        tgt, _ = _decode_name(data, rdstart + 6)
        rr.update({'priority': prio, 'weight': weight, 'port': port,
                   'target': tgt})
    elif rtype in (TYPE_CNAME, TYPE_DNAME):
        tgt, _ = _decode_name(data, rdstart)
        rr['target'] = tgt
    elif rtype == TYPE_SOA:
        mname, noff = _decode_name(data, rdstart)
        rname, noff = _decode_name(data, noff)
        serial, refresh, retry, expire, minimum = struct.unpack(
            '>IIIII', data[noff:noff + 20])
        rr.update({'mname': mname, 'minimum': minimum})
    return rr, off


class DnsMessage:
    """Parsed response; mirrors the mname-client message interface the
    resolver consumes (getAnswers/getAuthority/getAdditionals)."""

    def __init__(self, qid: int, rcode: str, tc: bool,
                 answers: list, authority: list, additionals: list):
        self.qid = qid
        self.rcode = rcode
        self.tc = tc
        self._answers = answers
        self._authority = authority
        self._additionals = additionals

    def get_answers(self) -> list:
        return self._answers

    getAnswers = get_answers

    def get_authority(self) -> list:
        return self._authority

    getAuthority = get_authority

    def get_additionals(self) -> list:
        return self._additionals

    getAdditionals = get_additionals


def parse_response(data: bytes) -> DnsMessage:
    qid, flags, qd, an, ns, ar = struct.unpack('>HHHHHH', data[:12])
    rcode = RCODES.get(flags & 0xF, 'RCODE%d' % (flags & 0xF))
    tc = bool(flags & 0x0200)
    off = 12
    for _ in range(qd):
        _, off = _decode_name(data, off)
        off += 4
    sections = []
    for count in (an, ns, ar):
        rrs = []
        for _ in range(count):
            rr, off = _parse_rr(data, off)
            rrs.append(rr)
        sections.append(rrs)
    return DnsMessage(qid, rcode, tc, *sections)


# ---------------------------------------------------------------------------
# Sans-io query core

class DnsQueryCore:
    """The pure per-resolver query state machine, no loop and no
    sockets: callers move the bytes, the core decides what they mean.

    Protocol::

        core = DnsQueryCore(domain, qtype)
        verb, payload = core.begin()          # ('udp', query bytes)
        while verb != 'done':
            data = <exchange payload via verb>
            verb, payload = core.on_response(data)
        msg = payload                         # parsed DnsMessage

    Decisions encoded (formerly inlined in ``_query_wire``):

    - FORMERR/NOTIMP on the FIRST (EDNS) response only -> retry once
      as a plain RFC 1035 query with a fresh qid (RFC 6891 6.2.2). A
      genuine FORMERR on the plain retry propagates as DnsError.
    - TC bit on either UDP response -> replay the current payload over
      TCP.
    - Any other non-NOERROR rcode -> DnsError.
    - Malformed bytes -> struct.error/ValueError propagate from
      ``parse_response``; timeout policy belongs to the driver.
    """

    def __init__(self, domain: str, qtype: str, rng=None,
                 resolver: str | None = None):
        self.domain = domain
        self.qtype = qtype
        self.resolver = resolver
        self._rng = rng if rng is not None else mod_utils.get_rng()
        # States: 'udp-edns' (first try, OPT attached) -> 'udp-plain'
        # (EDNS fallback) -> 'tcp' (truncation replay). The fallback
        # edge only exists from 'udp-edns'.
        self._state = 'udp-edns'
        self._payload = build_query(
            self._rng.randrange(65536), domain, qtype)

    def begin(self) -> tuple:
        return ('udp', self._payload)

    def on_response(self, data: bytes) -> tuple:
        msg = parse_response(data)
        if self._state == 'udp-edns' and \
                msg.rcode in ('FORMERR', 'NOTIMP'):
            self._state = 'udp-plain'
            self._payload = build_query(
                self._rng.randrange(65536), self.domain, self.qtype,
                edns_size=None)
            return ('udp', self._payload)
        if self._state != 'tcp' and msg.tc:
            self._state = 'tcp'
            return ('tcp', self._payload)
        if msg.rcode != 'NOERROR':
            raise DnsError(msg.rcode, self.domain, self.resolver)
        return ('done', msg)


# ---------------------------------------------------------------------------
# Transport

async def query_udp(resolver: str, port: int, payload: bytes,
                    timeout_s: float) -> bytes:
    from . import transport as mod_transport
    return await mod_transport.get_transport().dns_udp(
        resolver, port, payload, timeout_s)


async def query_tcp(resolver: str, port: int, payload: bytes,
                    timeout_s: float) -> bytes:
    from . import transport as mod_transport
    return await mod_transport.get_transport().dns_tcp(
        resolver, port, payload, timeout_s)


class DnsTransport:
    """Wire-transport seam: how raw query bytes reach a resolver and
    how raw response bytes come back. The default sends real datagrams
    and TCP streams on the running asyncio loop; netsim's SimWire
    (netsim/dns.py) substitutes a scripted middlebox so the
    full _query_wire state machine — EDNS fallback, TC->TCP retry,
    truncation errors, deadline sharing — runs against hostile answers
    without a socket (ROADMAP item 5's first consumer)."""

    async def udp(self, resolver: str, port: int, payload: bytes,
                  timeout_s: float) -> bytes:
        return await query_udp(resolver, port, payload, timeout_s)

    async def tcp(self, resolver: str, port: int, payload: bytes,
                  timeout_s: float) -> bytes:
        return await query_tcp(resolver, port, payload, timeout_s)


class DnsClient:
    """Resolver fan-out client (mname-client DnsClient equivalent).

    lookup(opts, cb): opts = {domain, type, timeout (ms), resolvers,
    errorThreshold?}; cb(err, msg). Tries resolvers in a randomized
    order, UDP first with TCP fallback on truncation; stops at the first
    clean answer. errorThreshold caps how many resolvers are tried
    (used by bootstrap resolvers, reference lib/resolver.js:1216-1219).
    """

    def __init__(self, concurrency: int = 3,
                 transport: DnsTransport | None = None):
        self.concurrency = max(1, concurrency)
        self.transport = transport or DnsTransport()

    def lookup(self, opts: dict, cb) -> None:
        # Fire-and-forget by design: _lookup is the reference's
        # callback-style contract (mname-client lookup(opts, cb)) —
        # every outcome, including exceptions, is delivered through
        # cb(err, result), so no task reference is kept.
        asyncio.ensure_future(self._lookup(opts, cb))  # cbflow: ignore=A004

    async def _query_one(self, resolver: str, domain: str, qtype: str,
                         timeout_s: float, trace=None) -> DnsMessage:
        """One resolver's attempt; when a DnsTrace rides along in
        opts['trace'], the whole attempt (UDP, EDNS fallback, TC->TCP)
        becomes one 'dns_query' span with its outcome."""
        if trace is None:
            return await self._query_wire(resolver, domain, qtype,
                                          timeout_s)
        span = trace.query_begin(resolver)
        try:
            msg = await self._query_wire(resolver, domain, qtype,
                                         timeout_s)
        except BaseException as err:
            trace.query_end(span, type(err).__name__)
            raise
        trace.query_end(span, 'ok')
        return msg

    async def _query_wire(self, resolver: str, domain: str, qtype: str,
                          timeout_s: float) -> DnsMessage:
        host, _, portstr = resolver.partition('@')
        port = int(portstr) if portstr else 53
        core = DnsQueryCore(domain, qtype, resolver=resolver)
        # One DEADLINE for this resolver's whole attempt: the EDNS
        # fallback and the TC->TCP retry each consume what remains,
        # never a fresh slice — otherwise one resolver could stretch
        # to 3x its budget and stall failover to the next wave. Read
        # through the clock seam so netsim's virtual clock (which also
        # backs the loop's own time()) drives the budget.
        clk = mod_utils.get_clock()
        deadline = clk.monotonic() + timeout_s

        def left() -> float:
            return max(deadline - clk.monotonic(), 0.001)
        verb, payload = core.begin()
        try:
            while verb != 'done':
                if verb == 'udp':
                    data = await self.transport.udp(host, port,
                                                    payload, left())
                else:
                    data = await self.transport.tcp(host, port,
                                                    payload, left())
                verb, payload = core.on_response(data)
        except (asyncio.TimeoutError, TimeoutError):
            raise DnsTimeoutError(domain, resolver)
        except struct.error as e:
            # Malformed packet; surface as a parse error rather than
            # letting it kill the lookup task.
            raise ValueError('malformed DNS response from %s: %s' % (
                resolver, e))
        return payload

    async def _lookup(self, opts: dict, cb) -> None:
        domain = opts['domain']
        qtype = opts['type']
        timeout_ms = opts.get('timeout') or 5000
        resolvers = list(opts.get('resolvers') or [])
        if not resolvers:
            cb(MultiError([DnsError('SERVFAIL', domain)]), None)
            return
        threshold = opts.get('errorThreshold') or len(resolvers)
        trace = opts.get('trace')

        mod_utils.get_rng().shuffle(resolvers)
        resolvers = resolvers[:threshold]
        errs: list[Exception] = []

        # Bounded parallel fan-out: up to `concurrency` resolvers are
        # queried at once; the first clean answer wins and the rest are
        # cancelled (mname-client's concurrency semantics).
        waves = [resolvers[i:i + self.concurrency]
                 for i in range(0, len(resolvers), self.concurrency)]
        per_wave_s = (timeout_ms / 1000.0) / len(waves)

        try:
            for wave in waves:
                tasks = [
                    asyncio.ensure_future(self._query_one(
                        r, domain, qtype, per_wave_s, trace=trace))
                    for r in wave]
                try:
                    pending = set(tasks)
                    while pending:
                        done, pending = await asyncio.wait(
                            pending,
                            return_when=asyncio.FIRST_COMPLETED)
                        for task in done:
                            try:
                                msg = task.result()
                            except asyncio.CancelledError:
                                continue
                            except Exception as e:
                                errs.append(e)
                                continue
                            cb(None, msg)
                            return
                finally:
                    for task in tasks:
                        if not task.done():
                            task.cancel()

            if len(errs) == 1:
                cb(errs[0], None)
            else:
                cb(MultiError(errs), None)
        except Exception as e:  # defense: the callback must always fire
            cb(e, None)
