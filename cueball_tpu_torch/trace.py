"""Claim-path span tracing: where did a claim's latency actually go?

The kang snapshot and the fleet sampler expose *structure* (FSM states,
queue depths); this module records *behavior*. When tracing is enabled,
every pool claim carries a `ClaimTrace` — a flat list of spans with
OTLP-compatible field names (trace_id / span_id / parent_span_id /
start / end / attrs) — decomposing its life into queue wait, CoDel
admission decisions, slot selection, connect + handshake, lease-held
time and release/requeue. DNS lookups get their own `DnsTrace` with one
child span per resolver attempt.

Completed traces land in a bounded per-process ring (O(1) append,
oldest dropped) and surface three ways:

  * `GET /kang/traces` on the debug HTTP server (NDJSON, one span per
    line — see http_server.py);
  * the SIGUSR2 dump (`debug.dump_fsm_histories()` folds in the slowest
    claims next to the FSM histories);
  * histograms / counters / gauges on an attached metrics Collector,
    served through the existing `/metrics` endpoint.

Zero dependencies and hot-path neutral when disabled: the only cost a
disabled tracer adds to the claim cycle is a module-global load plus a
None check (the same discipline as the pool's empty-tuple telemetry
walk), guarded by the bench A/B stage (`bench.py --host-only`) and
`tests/test_bench_guard.py`.

All span timestamps are monotonic milliseconds (`utils.current_millis`),
the same clock as `ch_started` and the FSM history ring — durations are
exact; absolute values are process-relative, not wall-clock.
"""

from __future__ import annotations

import collections
import json
import threading

from . import runq as mod_runq
from . import utils as mod_utils
from .events import _native

DEFAULT_RING_SIZE = 512

# With the C engine loaded, the hot path doesn't build these objects at
# all: trace.claim_begin hands the claim a NativeTrace token whose
# methods append fixed-width slots to a preallocated C ring
# (native/emitter.c, "Native trace recorder"), and the Python objects
# below are assembled lazily at export by replaying the ring through
# the SAME classes — which is what keeps the NDJSON byte-identical to
# the pure-Python recorder. The event ring is sized as a multiple of
# the completed-trace ring (a claim emits ~6 events).
NATIVE_EVENTS_PER_TRACE = 16

_NATIVE_TRACE_OK = _native is not None and \
    hasattr(_native, 'trace_claim_begin')

# Event codes — must match the TREV_* defines in native/emitter.c.
_EV_CLAIM_BEGIN = 1
_EV_CODEL = 2
_EV_SLOT = 3
_EV_CLAIMING = 4
_EV_CLAIMED = 5
_EV_REQUEUED = 6
_EV_RELEASED = 7
_EV_FAILED = 8
_EV_CANCELLED = 9
_EV_DNS_BEGIN = 10
_EV_DNS_QBEGIN = 11
_EV_DNS_QEND = 12
_EV_DNS_DONE = 13

# Reserved wire-event codes (WEV_* in the future native transport):
# the fixed slots a native data path appends per Transport seam for
# the wiretap ledger. They share the event ring with the TREV_* codes
# above but are NOT trace events — _drain_native skips them without
# touching the pending map or the truncation counter. The mapping is
# part of the NativeTransport conformance contract and follows
# transport.SEAM_METHODS / wiretap.SEAMS order.
_EV_WIRE_FIRST = 14
WIRE_EVENT_CODES = {
    'connector': 14,
    'create_stream': 15,
    'serve': 16,
    'dns_udp': 17,
    'dns_tcp': 18,
}

# Cap on traces whose begin event has drained but whose terminal event
# hasn't: protects the assembler against claims that never finish.
_PENDING_MAX = 4096

# Histograms the runtime feeds from completed spans (all milliseconds).
TRACE_HISTOGRAMS = {
    'cueball_claim_wait_ms':
        'Time a claim spent queued before a slot was assigned (ms)',
    'cueball_connect_ms':
        'TCP connect + constructor time per backend connect (ms)',
    'cueball_handshake_ms':
        'Slot claim handshake time, claiming to claimed (ms)',
    'cueball_lease_held_ms':
        'Time a claimed connection was held before release (ms)',
    'cueball_dns_lookup_ms':
        'DNS lookup round-trip time (ms)',
}

# Per-phase claim cost, fed from the profile module's phase ledger at
# completion time (labelled, so declared separately from the plain
# histograms above).
PHASE_HISTOGRAM = 'cueball_claim_phase_ms'
PHASE_HISTOGRAM_HELP = ('Per-claim time attributed to one claim-path '
                        'phase by the profile ledger (ms)')

SHED_COUNTER = 'cueball_codel_shed_total'
SHED_HELP = 'Claims shed by CoDel admission control, by reason'

# Per-pool gauges refreshed lazily at scrape time from the same
# mark_dirty() hooks that drive the fleet sampler's TelemetryRowHandle.
POOL_GAUGES = {
    'cueball_queue_depth': 'Claims waiting in the pool claim queue',
    'cueball_open_slots': 'Connection slots open (all states)',
    'cueball_idle_slots': 'Connection slots idle (claimable)',
    'cueball_busy_slots': 'Connection slots busy (claimed)',
    'cueball_pending_slots': 'Connection slots still connecting',
}

# Self-observability of the recorder itself: the flight recorder must
# say when it is dropping its own film.
RING_DROPPED_COUNTER = 'cueball_trace_ring_dropped_total'
RING_DROPPED_HELP = \
    'Native trace-ring event slots overwritten before export'
RING_GAUGES = {
    'cueball_trace_ring_highwater':
        'Peak undrained event slots in the native trace ring',
    'cueball_pump_queue_depth':
        'Callbacks waiting in the engine run-queue pump',
}


# -- shard identity ---------------------------------------------------------
# Each FleetRouter shard thread/process stamps its id here at bootstrap;
# spans record it so the merged export surfaces keep a per-shard
# breakdown. Thread-local because thread-backend shards share this
# module; the native recorder mirrors it into a C thread-local so slots
# written without any Python payload still carry the shard (flags bits
# 8+, biased by +1 so 0 keeps meaning "no shard").

_SHARD_TLS = threading.local()
_SHARD_FROM_TLS = object()  # sentinel: "read the caller's TLS"
_SHARD_FLAG_SHIFT = 8


def set_shard_id(shard_id: int | None) -> None:
    """Tag the calling thread (and, through the C TLS, every native
    trace slot it writes) with a FleetRouter shard id. None clears."""
    _SHARD_TLS.shard = None if shard_id is None else int(shard_id)
    if _NATIVE_TRACE_OK and hasattr(_native, 'trace_set_shard'):
        _native.trace_set_shard(-1 if shard_id is None else int(shard_id))


def get_shard_id() -> int | None:
    return getattr(_SHARD_TLS, 'shard', None)


def _shard_from_flags(flags: int) -> int | None:
    sid = ((int(flags) >> _SHARD_FLAG_SHIFT) & 0xFFF) - 1
    return sid if sid >= 0 else None


# -- backend identity -------------------------------------------------------
# Stable small integers for backend keys, shared by every attribution
# surface: the native recorder stamps the index into slot flags (bits
# 20+, biased by +1 like the shard field) and the health engine's
# BackendTable uses the same index as its row number, so a claim
# attributed by the C ring and one attributed by the Python recorder
# land in the same per-backend column. Index 0 is RESERVED for the
# unattributed bucket (key ''): claims that never reached a backend.

_BACKEND_LOCK = threading.Lock()
_BACKEND_KEYS: list = ['']
_BACKEND_IDS: dict = {'': 0}
_BACKEND_FLAG_SHIFT = 20
#: 12 flag bits, biased by +1: indexes past this fall back to row 0.
BACKEND_INDEX_MAX = 0xFFE


def backend_index(key) -> int:
    """The stable row index for a backend key (registering it on first
    sight). Falls back to 0 (unattributed) when the registry is full,
    so the flag stamp can never alias two real backends."""
    key = str(key or '')
    idx = _BACKEND_IDS.get(key)
    if idx is not None:
        return idx
    with _BACKEND_LOCK:
        idx = _BACKEND_IDS.get(key)
        if idx is None:
            if len(_BACKEND_KEYS) > BACKEND_INDEX_MAX:
                return 0
            idx = len(_BACKEND_KEYS)
            _BACKEND_KEYS.append(key)
            _BACKEND_IDS[key] = idx
    return idx


def backend_key_for(index: int) -> str | None:
    """Reverse lookup; None for indexes never registered."""
    if not 0 <= index < len(_BACKEND_KEYS):
        return None
    return _BACKEND_KEYS[index]


def backend_known(key) -> bool:
    """True when the backend key has ever been registered (seen by a
    trace or telemetry path) — lets /kang/traces reject filters naming
    backends that never existed instead of returning an empty body."""
    return str(key or '') in _BACKEND_IDS


def _backend_from_flags(flags: int) -> str | None:
    idx = ((int(flags) >> _BACKEND_FLAG_SHIFT) & 0xFFF) - 1
    return backend_key_for(idx) if idx >= 0 else None


# Attribution sinks (the health engine's BackendTable): every finished
# claim and every CoDel shed is offered to each sink with its backend
# key, on whatever thread completed it. Copy-on-write tuple like
# _EXPORT_SOURCES so the hot path pays one load when empty.
_BACKEND_SINKS: tuple = ()


def add_backend_sink(sink) -> None:
    """Register an attribution sink: an object with
    ``observe(key, service_ms, claim_ms, ok)`` and
    ``observe_shed(key)``."""
    global _BACKEND_SINKS
    _BACKEND_SINKS = _BACKEND_SINKS + (sink,)


def remove_backend_sink(sink) -> None:
    global _BACKEND_SINKS
    _BACKEND_SINKS = tuple(
        s for s in _BACKEND_SINKS if s is not sink)


# External NDJSON producers merged into export_ndjson() — the seam the
# FleetRouter's spawn backend uses to fold child-process trace rings
# into the parent's /kang/traces view. Each source is a zero-arg
# callable returning an NDJSON string ('' when it has nothing).
_EXPORT_SOURCES: tuple = ()


def add_export_source(fn) -> None:
    global _EXPORT_SOURCES
    _EXPORT_SOURCES = _EXPORT_SOURCES + (fn,)


def remove_export_source(fn) -> None:
    global _EXPORT_SOURCES
    _EXPORT_SOURCES = tuple(f for f in _EXPORT_SOURCES if f is not fn)


def _new_trace_id() -> str:
    return '%032x' % mod_utils.get_rng().getrandbits(128)


def _new_span_id() -> str:
    return '%016x' % mod_utils.get_rng().getrandbits(64)


_M64 = (1 << 64) - 1


def _span_id_from(seed: int, index: int) -> str:
    """Deterministic span id: splitmix64 of (trace seed, span index).

    Span ids used to be independent RNG draws, which would make the
    native recorder's lazily-assembled spans diverge from the pure
    recorder's (the draws happen at different times). Deriving them
    from the trace id — itself still one RNG draw — makes the id a
    pure function of (trace, position), so both recorders emit
    byte-identical NDJSON while consuming identical RNG streams."""
    z = (seed + (index + 1) * 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    z ^= z >> 31
    return '%016x' % z


class Span:
    """One timed operation. `end is None` means still open; event spans
    are recorded with end == start."""

    __slots__ = ('name', 'span_id', 'parent_span_id', 'start', 'end',
                 'attrs')

    def __init__(self, name: str, parent_span_id: str | None,
                 start: float, attrs: dict | None = None,
                 span_id: str | None = None):
        self.name = name
        self.span_id = _new_span_id() if span_id is None else span_id
        self.parent_span_id = parent_span_id
        self.start = start
        self.end = None
        self.attrs = dict(attrs or {})

    def duration(self) -> float | None:
        if self.end is None:
            return None
        return self.end - self.start


class Trace:
    """A flat span list sharing one trace_id; spans[0] is the root."""

    __slots__ = ('trace_id', 'spans', 'tr_runtime', 'tr_sid_seed')

    root_name = 'trace'

    def __init__(self, runtime: '_TraceRuntime', attrs: dict | None = None,
                 start: float | None = None,
                 trace_id_int: int | None = None):
        if trace_id_int is None:
            trace_id_int = mod_utils.get_rng().getrandbits(128)
        self.trace_id = '%032x' % trace_id_int
        self.tr_sid_seed = trace_id_int & _M64
        self.tr_runtime = runtime
        if start is None:
            start = mod_utils.current_millis()
        self.spans = []
        self._new_span(self.root_name, None, start, attrs)

    @property
    def root(self) -> Span:
        return self.spans[0]

    def _new_span(self, name: str, parent_span_id: str | None,
                  start: float, attrs: dict | None = None) -> Span:
        span = Span(name, parent_span_id, start, attrs,
                    span_id=_span_id_from(self.tr_sid_seed,
                                          len(self.spans)))
        self.spans.append(span)
        return span

    def begin_span(self, name: str, attrs: dict | None = None,
                   start: float | None = None) -> Span:
        if start is None:
            start = mod_utils.current_millis()
        return self._new_span(name, self.root.span_id, start, attrs)

    def end_span(self, span: Span, end: float | None = None) -> None:
        if span.end is None:
            span.end = mod_utils.current_millis() if end is None else end

    def add_event(self, name: str, attrs: dict | None = None,
                  now: float | None = None) -> Span:
        """A zero-duration decision/event span (end == start)."""
        span = self.begin_span(name, attrs, start=now)
        span.end = span.start
        return span

    def span_totals(self) -> dict:
        """Sum of closed-span durations per span name (ms)."""
        totals: dict = {}
        for span in self.spans[1:]:
            d = span.duration()
            if d is not None:
                totals[span.name] = totals.get(span.name, 0.0) + d
        return totals

    def finish(self, outcome: str, end: float | None = None) -> None:
        """Close the root span and hand the trace to the ring; safe to
        call more than once (terminal FSM states can chain, e.g.
        released -> closed)."""
        root = self.root
        if root.end is not None:
            return
        root.attrs['outcome'] = outcome
        root.end = mod_utils.current_millis() if end is None else end
        for span in self.spans[1:]:
            if span.end is None:
                span.end = root.end
        self.tr_runtime.completed(self)

    def ndjson_lines(self) -> list:
        out = []
        for span in self.spans:
            out.append(json.dumps({
                'trace_id': self.trace_id,
                'span_id': span.span_id,
                'parent_span_id': span.parent_span_id,
                'name': span.name,
                'start': span.start,
                'end': span.end,
                'attrs': span.attrs,
            }, sort_keys=True))
        return out


class ClaimTrace(Trace):
    """Spans for one pool/set claim. The claim handle calls exactly one
    guarded method per FSM transition; every method tolerates arriving
    in unexpected orders (terminal states finish idempotently)."""

    __slots__ = ('ct_queue_span', 'ct_handshake_span', 'ct_lease_span',
                 'ct_backend')

    root_name = 'claim'

    def __init__(self, runtime: '_TraceRuntime', pool,
                 start: float | None = None,
                 trace_id_int: int | None = None,
                 ident: tuple | None = None):
        # 'pool' may be a ConnectionPool or a ConnectionSet standing in
        # as one (cset claims hand the set itself down), so everything
        # here is getattr-guarded. Replay passes the (pool, domain[,
        # shard]) identity captured at emit time instead of the live
        # object. Pools owned by a FleetRouter shard carry p_shard and
        # stamp it on the span; plain pools produce the exact
        # pre-sharding attrs (no 'shard' key), keeping unsharded
        # exports byte-identical.
        if ident is None:
            uuid = getattr(pool, 'p_uuid', None) or \
                getattr(pool, 'cs_uuid', None) or ''
            domain = getattr(pool, 'p_domain', None) or \
                getattr(pool, 'cs_domain', None) or ''
            shard = getattr(pool, 'p_shard', None)
            if shard is None:
                shard = getattr(pool, 'cs_shard', None)
            ident = (str(uuid), str(domain))
            if shard is not None:
                ident += (int(shard),)
        attrs = {
            'kind': 'claim',
            'pool': ident[0],
            'domain': ident[1],
        }
        if len(ident) > 2 and ident[2] is not None:
            attrs['shard'] = ident[2]
        Trace.__init__(self, runtime, attrs,
                       start=start, trace_id_int=trace_id_int)
        self.ct_queue_span = self.begin_span('queue_wait',
                                             start=self.root.start)
        self.ct_handshake_span = None
        self.ct_lease_span = None
        self.ct_backend = ''

    def codel_decision(self, decision: str, sojourn_ms: float,
                       target_ms: float, now: float | None = None) -> None:
        self.add_event('codel', {
            'decision': decision,
            'sojourn_ms': round(float(sojourn_ms), 3),
            'target_ms': float(target_ms),
        }, now=now)

    def slot_selected(self, source: str, now: float | None = None) -> None:
        self.add_event('slot_select', {'source': source}, now=now)

    def claiming(self, slot) -> None:
        """Queue wait is over; the claim handshake with `slot` begins.
        The serving slot's last connect is attached as a child span so
        the trace shows where connect time went even when the connect
        predates the claim (attrs.during_claim says which)."""
        backend = ''
        last = None
        smgr = None
        get_smgr = getattr(slot, 'get_socket_mgr', None)
        if get_smgr is not None:
            smgr = get_smgr()
        if smgr is not None:
            be = getattr(smgr, 'sm_backend', None) or {}
            backend = str(be.get('key') or '')
            last = getattr(smgr, 'sm_last_connect', None)
            if last is not None:
                cstart, cend = last
                last = (cstart, cend)
        self._claiming_at(backend, last, mod_utils.current_millis())

    def _claiming_at(self, backend: str, last: tuple | None,
                     now: float) -> None:
        self.ct_backend = backend or ''
        self.end_span(self.ct_queue_span, now)
        if last is not None:
            cstart, cend = last
            span = self._new_span(
                'connect', self.root.span_id, cstart,
                {'backend': backend,
                 'during_claim': cend >= self.root.start})
            span.end = cend
        self.ct_handshake_span = self.begin_span(
            'handshake', {'backend': backend}, start=now)

    def claimed(self, now: float | None = None) -> None:
        if now is None:
            now = mod_utils.current_millis()
        if self.ct_handshake_span is not None:
            self.end_span(self.ct_handshake_span, now)
        self.ct_lease_span = self.begin_span('lease', start=now)

    def requeued(self, now: float | None = None) -> None:
        """The slot rejected the handshake; the claim is back in the
        queue. Only meaningful when a handshake was open."""
        if self.ct_handshake_span is None:
            return
        if now is None:
            now = mod_utils.current_millis()
        if self.ct_handshake_span.end is None:
            self.ct_handshake_span.attrs['outcome'] = 'rejected'
            self.end_span(self.ct_handshake_span, now)
        self.ct_handshake_span = None
        self.add_event('requeue', now=now)
        self.ct_queue_span = self.begin_span(
            'queue_wait', {'requeue': True}, start=now)

    def released(self, how: str, now: float | None = None) -> None:
        if now is None:
            now = mod_utils.current_millis()
        if self.ct_lease_span is not None:
            self.end_span(self.ct_lease_span, now)
        if self.root.end is None:
            self.add_event('release', {'how': how}, now=now)
        self.finish('released' if how == 'release' else 'closed',
                    end=now)

    def failed(self, err) -> None:
        self._fail_named(type(err).__name__ if err is not None else None)

    def _fail_named(self, errname: str | None,
                    now: float | None = None) -> None:
        if errname is not None:
            self.root.attrs['error'] = errname
        self.finish('failed', end=now)

    def cancelled(self, now: float | None = None) -> None:
        self.finish('cancelled', end=now)


class DnsTrace(Trace):
    """Spans for one DNS resolution: a root lookup span plus one
    `dns_query` child per resolver attempt (dns_client)."""

    __slots__ = ()

    root_name = 'dns_lookup'

    def __init__(self, runtime: '_TraceRuntime', domain: str, rtype: str,
                 start: float | None = None,
                 trace_id_int: int | None = None,
                 shard=_SHARD_FROM_TLS):
        # Live construction reads the caller's shard id off the thread
        # local (a DNS lookup has no pool to carry it); native replay
        # passes the shard decoded from the slot's flags explicitly —
        # including None — so the drain thread's own TLS never leaks
        # into replayed traces.
        if shard is _SHARD_FROM_TLS:
            shard = get_shard_id()
        attrs = {
            'kind': 'dns',
            'domain': str(domain),
            'type': str(rtype),
        }
        if shard is not None:
            attrs['shard'] = int(shard)
        Trace.__init__(self, runtime, attrs,
                       start=start, trace_id_int=trace_id_int)

    def query_begin(self, resolver: str,
                    now: float | None = None) -> Span:
        return self.begin_span('dns_query', {'resolver': str(resolver)},
                               start=now)

    def query_end(self, span: Span, outcome: str,
                  now: float | None = None) -> None:
        span.attrs['outcome'] = outcome
        self.end_span(span, end=now)

    def done(self, outcome: str, err=None) -> None:
        self._done_named(outcome,
                         type(err).__name__ if err is not None else None)

    def _done_named(self, outcome: str, errname: str | None,
                    now: float | None = None) -> None:
        if errname is not None:
            self.root.attrs['error'] = errname
        self.finish(outcome, end=now)


class _GaugeRow:
    """Speaks the pool's telemetry_attach protocol (the same hooks that
    drive the fleet sampler's TelemetryRowHandle): the pool marks the
    row dirty on every state-moving event, and the runtime re-reads the
    pool's gauges only on scrapes where something changed."""

    __slots__ = ('gr_pool', 'gr_labels', 'gr_dirty')

    def __init__(self, pool, labels: dict):
        self.gr_pool = pool
        self.gr_labels = labels
        self.gr_dirty = True

    def mark_dirty(self) -> None:
        self.gr_dirty = True


class _TraceRuntime:
    """Process-global tracer state: the completed-trace ring, the
    sampling decision, and the optional metric aggregation."""

    def __init__(self, ring_size: int = DEFAULT_RING_SIZE,
                 sample_rate: float = 1.0, collector=None,
                 native: bool | None = None):
        if ring_size < 1:
            raise ValueError('ring_size must be >= 1')
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError('sample_rate must be within [0, 1]')
        if native is None:
            native = _NATIVE_TRACE_OK
        self.tr_native = bool(native) and _NATIVE_TRACE_OK
        self.tr_ring: collections.deque = collections.deque(
            maxlen=int(ring_size))
        self.tr_sample = float(sample_rate)
        self.tr_collector = collector
        self.tr_seen = 0
        self.tr_sampled = 0
        self.tr_rows: dict = {}
        self.tr_generation = None
        # Traces whose begin event has drained but whose terminal event
        # hasn't: serial -> [trace, dns_query_token_map_or_None].
        self.tr_pending: dict = {}
        self.tr_truncated = 0
        self.tr_evicted = 0
        self.tr_dropped_reported = 0
        if collector is not None:
            for name, help_ in TRACE_HISTOGRAMS.items():
                collector.histogram(name, help=help_)
            collector.histogram(PHASE_HISTOGRAM, help=PHASE_HISTOGRAM_HELP)
            collector.counter(SHED_COUNTER, help=SHED_HELP)
            collector.counter(RING_DROPPED_COUNTER,
                              help=RING_DROPPED_HELP)
            for name, help_ in POOL_GAUGES.items():
                collector.gauge(name, help=help_)
            for name, help_ in RING_GAUGES.items():
                collector.gauge(name, help=help_)
            collector.add_collect_hook(self.refresh_gauges)
        if self.tr_native:
            _native.trace_ring_configure(
                int(ring_size) * NATIVE_EVENTS_PER_TRACE)
            _sync_native_clock()
            # Bound module functions cached for the per-claim path.
            self.tr_nclaim = _native.trace_claim_begin
            self.tr_ndns = _native.trace_dns_begin

    # -- sampling ---------------------------------------------------------

    def _sampled(self) -> bool:
        self.tr_seen += 1
        rate = self.tr_sample
        if rate >= 1.0:
            sampled = True
        elif rate <= 0.0:
            sampled = False
        else:
            sampled = mod_utils.get_rng().random() < rate
        if sampled:
            self.tr_sampled += 1
        return sampled

    # -- claim-path hooks (called from pool / connection_fsm / cset) ------

    def claim_begin(self, handle, pool) -> None:
        # _sampled() inlined: this runs once per claim at rate 1.0.
        self.tr_seen += 1
        rate = self.tr_sample
        if rate < 1.0:
            if rate <= 0.0 or \
                    not mod_utils.get_rng().random() < rate:
                return
        self.tr_sampled += 1
        start = getattr(handle, 'ch_started', None)
        if self.tr_native:
            try:
                ident = pool._tr_claim_ident
            except AttributeError:
                ident = self._claim_ident(pool)
            if start is None:
                start = mod_utils.current_millis()
            handle.ch_trace = self.tr_nclaim(
                (mod_utils.get_rng().getrandbits(128), ident), start)
        else:
            handle.ch_trace = ClaimTrace(self, pool, start=start)

    def _claim_ident(self, pool) -> tuple:
        """(pool uuid, domain[, shard]) as strings (shard an int),
        cached on the pool so the native fast path pays one attribute
        load instead of four. Shard-owned pools (FleetRouter sets
        p_shard right after construction, before any claim) get the
        3-tuple; plain pools keep the 2-tuple so their exports are
        bit-for-bit what they were before sharding existed."""
        uuid = getattr(pool, 'p_uuid', None) or \
            getattr(pool, 'cs_uuid', None) or ''
        domain = getattr(pool, 'p_domain', None) or \
            getattr(pool, 'cs_domain', None) or ''
        ident = (str(uuid), str(domain))
        shard = getattr(pool, 'p_shard', None)
        if shard is None:
            shard = getattr(pool, 'cs_shard', None)
        if shard is not None:
            ident += (int(shard),)
        try:
            pool._tr_claim_ident = ident
        except (AttributeError, TypeError):
            pass
        return ident

    def connect_done(self, backend_key, start: float, end: float) -> None:
        self.observe('cueball_connect_ms', end - start)

    def codel_shed(self, handle, reason: str, sojourn_ms: float,
                   target_ms: float) -> None:
        if self.tr_collector is not None:
            self.tr_collector.counter(SHED_COUNTER, help=SHED_HELP) \
                .increment({'reason': reason})
        trace = getattr(handle, 'ch_trace', None)
        sinks = _BACKEND_SINKS
        if sinks:
            # Sheds strike queued claims, so most are unattributed
            # (row 0); a requeued claim keeps its last backend.
            key = getattr(trace, 'ct_backend', '') or ''
            for sink in sinks:
                sink.observe_shed(key)
        if trace is not None:
            trace.codel_decision('shed-' + reason, sojourn_ms, target_ms)

    def dns_begin(self, domain: str, rtype: str):
        if not self._sampled():
            return None
        if self.tr_native:
            return self.tr_ndns(
                (mod_utils.get_rng().getrandbits(128),
                 str(domain), str(rtype)),
                mod_utils.current_millis())
        return DnsTrace(self, domain, rtype)

    def observe(self, name: str, value_ms: float) -> None:
        if self.tr_collector is not None and value_ms is not None:
            self.tr_collector.histogram(
                name, help=TRACE_HISTOGRAMS.get(name, '')) \
                .observe(value_ms)

    # -- completion -------------------------------------------------------

    def completed(self, trace: Trace) -> None:
        if len(self.tr_ring) == self.tr_ring.maxlen:
            self.tr_evicted += 1
        self.tr_ring.append(trace)
        sinks = _BACKEND_SINKS
        if sinks and isinstance(trace, ClaimTrace):
            outcome = trace.root.attrs.get('outcome')
            if outcome != 'cancelled':
                lease = trace.ct_lease_span
                service = (lease.duration()
                           if lease is not None else None)
                ok = outcome in ('released', 'closed')
                claim_ms = trace.root.duration()
                for sink in sinks:
                    sink.observe(trace.ct_backend, service,
                                 claim_ms, ok)
        if self.tr_collector is None:
            return
        totals = trace.span_totals()
        if isinstance(trace, ClaimTrace):
            if 'queue_wait' in totals:
                self.observe('cueball_claim_wait_ms', totals['queue_wait'])
            if 'handshake' in totals:
                self.observe('cueball_handshake_ms', totals['handshake'])
            if 'lease' in totals:
                self.observe('cueball_lease_held_ms', totals['lease'])
            from . import profile as mod_profile
            led = mod_profile.claim_ledger(trace)
            if led is not None:
                hist = self.tr_collector.histogram(
                    PHASE_HISTOGRAM, help=PHASE_HISTOGRAM_HELP)
                for phase, ms in led['phases'].items():
                    if ms > 0.0:
                        hist.observe(ms, labels={'phase': phase})
        elif isinstance(trace, DnsTrace):
            self.observe('cueball_dns_lookup_ms', trace.root.duration())

    # -- native ring drain ------------------------------------------------

    def _drain_native(self) -> None:
        """Replay the C event ring through the real trace classes.

        This is the lazy half of the native recorder: the hot path
        wrote fixed-width slots; here — only at export/scrape — those
        slots are replayed through the SAME ClaimTrace/DnsTrace methods
        the pure recorder drives inline, with the recorded timestamps
        passed as now=/start=. Byte-identical NDJSON by construction.

        Terminal events deliberately do NOT remove the pending entry:
        terminal states can chain (released -> closed) and finish() is
        idempotent, so a later terminal event on the same serial must
        still find its trace. Entries age out of the bounded pending
        map instead; an unfinished trace evicted that way (or an event
        whose begin slot was already overwritten) counts as truncated."""
        if not self.tr_native:
            return
        events = _native.trace_ring_drain()
        if not events:
            return
        pending = self.tr_pending
        for code, serial, t, a, b, obj, flags in events:
            if code >= _EV_WIRE_FIRST:
                # Reserved wire-event slot (native transport wiretap
                # counters): not a trace event, never truncation.
                continue
            if code == _EV_CLAIM_BEGIN:
                tid, ident = obj
                pending[serial] = [
                    ClaimTrace(self, None, start=t,
                               trace_id_int=tid, ident=ident),
                    None,
                ]
            elif code == _EV_DNS_BEGIN:
                tid, domain, rtype = obj
                pending[serial] = [
                    DnsTrace(self, domain, rtype, start=t,
                             trace_id_int=tid,
                             shard=_shard_from_flags(flags)),
                    None,
                ]
            else:
                ent = pending.get(serial)
                if ent is None:
                    self.tr_truncated += 1
                    # The begin slot was overwritten, but terminal
                    # claim events still carry the backend index in
                    # their flags: attribution survives truncation.
                    sinks = _BACKEND_SINKS
                    if sinks and code in (_EV_RELEASED, _EV_FAILED):
                        key = _backend_from_flags(flags) or ''
                        for sink in sinks:
                            sink.observe(key, None, None,
                                         code == _EV_RELEASED)
                    continue
                trace = ent[0]
                if code == _EV_CODEL:
                    trace.codel_decision(obj, a, b, now=t)
                elif code == _EV_SLOT:
                    trace.slot_selected(obj, now=t)
                elif code == _EV_CLAIMING:
                    trace._claiming_at(
                        obj, (a, b) if flags & 1 else None, t)
                elif code == _EV_CLAIMED:
                    trace.claimed(now=t)
                elif code == _EV_REQUEUED:
                    trace.requeued(now=t)
                elif code == _EV_RELEASED:
                    trace.released(obj, now=t)
                elif code == _EV_FAILED:
                    trace._fail_named(obj, now=t)
                elif code == _EV_CANCELLED:
                    trace.cancelled(now=t)
                elif code == _EV_DNS_QBEGIN:
                    qmap = ent[1]
                    if qmap is None:
                        qmap = ent[1] = {}
                    qmap[int(a)] = trace.query_begin(obj, now=t)
                elif code == _EV_DNS_QEND:
                    qmap = ent[1]
                    span = qmap.pop(int(a), None) if qmap else None
                    if span is not None:
                        trace.query_end(span, obj, now=t)
                elif code == _EV_DNS_DONE:
                    outcome, errname = obj
                    trace._done_named(outcome, errname, now=t)
                continue
            if len(pending) > _PENDING_MAX:
                ent = pending.pop(next(iter(pending)))
                if ent[0].root.end is None:
                    self.tr_truncated += 1

    def _refresh_ring_health(self) -> None:
        """Scrape-time ring self-observability: dropped-slot counter
        (delta-exported from the C ring's monotonic total), undrained
        high-water gauge, and the run-queue pump depth."""
        if self.tr_collector is None:
            return
        highwater = 0
        if self.tr_native:
            stats = _native.trace_ring_stats()
            dropped = stats['dropped']
            delta = dropped - self.tr_dropped_reported
            if delta > 0:
                self.tr_dropped_reported = dropped
                self.tr_collector.counter(
                    RING_DROPPED_COUNTER, help=RING_DROPPED_HELP) \
                    .increment(value=delta)
            highwater = stats['highwater']
        self.tr_collector.gauge(
            'cueball_trace_ring_highwater',
            help=RING_GAUGES['cueball_trace_ring_highwater']) \
            .set(highwater)
        self.tr_collector.gauge(
            'cueball_pump_queue_depth',
            help=RING_GAUGES['cueball_pump_queue_depth']) \
            .set(mod_runq.pump_depth())

    # -- per-pool gauges --------------------------------------------------

    def refresh_gauges(self) -> None:
        """Collect-time refresh: reconcile the pool roster (via the
        monitor's generation counter, as the sampler does), then re-read
        gauges only for pools whose telemetry row was marked dirty."""
        if self.tr_collector is None:
            return
        self._drain_native()
        self._refresh_ring_health()
        from . import monitor as mod_monitor
        mon = mod_monitor.pool_monitor
        gen = mon.pm_generation
        if gen != self.tr_generation:
            self.tr_generation = gen
            live = dict(mon.pm_pools)
            for uuid in list(self.tr_rows):
                if uuid not in live:
                    self._drop_row(uuid)
            for uuid, pool in live.items():
                if uuid in self.tr_rows:
                    continue
                if getattr(pool, 'telemetry_attach', None) is None:
                    continue
                labels = {
                    'pool': str(uuid),
                    'domain': str(getattr(pool, 'p_domain', '')),
                }
                shard = getattr(pool, 'p_shard', None)
                if shard is not None:
                    labels['shard'] = str(shard)
                row = _GaugeRow(pool, labels)
                self.tr_rows[uuid] = row
                pool.telemetry_attach(row)
        for row in self.tr_rows.values():
            if not row.gr_dirty:
                continue
            row.gr_dirty = False
            stats = row.gr_pool.get_stats()
            total = stats['totalConnections']
            idle = stats['idleConnections']
            pending = stats['pendingConnections']
            values = {
                'cueball_queue_depth': stats['waiterCount'],
                'cueball_open_slots': total,
                'cueball_idle_slots': idle,
                'cueball_busy_slots': max(total - idle - pending, 0),
                'cueball_pending_slots': pending,
            }
            for name, v in values.items():
                self.tr_collector.gauge(
                    name, help=POOL_GAUGES[name]).set(v, row.gr_labels)

    def _drop_row(self, uuid) -> None:
        row = self.tr_rows.pop(uuid, None)
        if row is None:
            return
        detach = getattr(row.gr_pool, 'telemetry_detach', None)
        if detach is not None:
            detach(row)
        for name in POOL_GAUGES:
            self.tr_collector.gauge(
                name, help=POOL_GAUGES[name]).remove(row.gr_labels)

    def shutdown(self) -> None:
        for uuid in list(self.tr_rows):
            self._drop_row(uuid)
        if self.tr_collector is not None:
            self.tr_collector.remove_collect_hook(self.refresh_gauges)
        if self.tr_native:
            mod_utils.remove_clock_hook(_sync_native_clock)
            _native.trace_ring_configure(0)
            _native.trace_set_clock(None)
            self.tr_pending.clear()


# The one per-process runtime; None when tracing is off. Hot-path call
# sites read this module global directly and branch on None — keep it a
# simple attribute so the disabled cost stays one load + one check.
_runtime: _TraceRuntime | None = None


def _sync_native_clock(*_clock) -> None:
    """Keep the C recorder on the same clock as utils.current_millis():
    under the real SystemClock the C side reads CLOCK_MONOTONIC
    directly (no Python in the hot path); any substituted clock
    (netsim's VirtualClock) routes through a Python callback so
    virtual-time traces stay parity-exact. Registered as a
    utils.add_clock_hook so mid-run set_clock() switches follow."""
    if not _NATIVE_TRACE_OK:
        return
    if isinstance(mod_utils.get_clock(), mod_utils.SystemClock):
        _native.trace_set_clock(None)
    else:
        _native.trace_set_clock(mod_utils.current_millis)


def enable_tracing(ring_size: int = DEFAULT_RING_SIZE,
                   sample_rate: float = 1.0,
                   collector=None,
                   native: bool | None = None) -> _TraceRuntime:
    """Turn on claim-path tracing process-wide. `collector` (a
    metrics.Collector) is optional: without one, traces land in the
    ring and on /kang/traces but no histograms/gauges are fed.
    `native` selects the C event-ring recorder (None = use it whenever
    the C engine is loaded; False forces the pure-Python recorder)."""
    global _runtime
    if _runtime is not None:
        disable_tracing()
    _runtime = _TraceRuntime(ring_size, sample_rate, collector, native)
    if _runtime.tr_native:
        mod_utils.add_clock_hook(_sync_native_clock)
    return _runtime


def disable_tracing() -> None:
    """Turn tracing off and detach every pool hook it installed."""
    global _runtime
    runtime = _runtime
    _runtime = None
    if runtime is not None:
        runtime.shutdown()


def tracing_enabled() -> bool:
    return _runtime is not None


def active_collector():
    """The enabled runtime's Collector (or None): lets other metric
    producers (e.g. the fleet sampler) publish onto the same canonical
    surface without plumbing a collector of their own."""
    runtime = _runtime
    return runtime.tr_collector if runtime is not None else None


def trace_ring() -> list:
    """Completed traces, oldest first (a copy; safe to iterate)."""
    runtime = _runtime
    if runtime is None:
        return []
    runtime._drain_native()
    return list(runtime.tr_ring)


def export_ndjson() -> str:
    """All ring spans as NDJSON, one span per line, oldest trace first
    (the /kang/traces payload), followed by any registered external
    sources (child-process shard rings). Empty string when tracing is
    off and no source has anything."""
    runtime = _runtime
    lines: list = []
    if runtime is not None:
        runtime._drain_native()
        for trace in runtime.tr_ring:
            lines.extend(trace.ndjson_lines())
    out = '\n'.join(lines) + '\n' if lines else ''
    for fn in _EXPORT_SOURCES:
        try:
            extra = fn()
        except Exception:
            extra = ''
        if extra:
            out += extra if extra.endswith('\n') else extra + '\n'
    return out


def filter_ndjson(text: str, limit: int | None = None,
                  backend: str | None = None) -> str:
    """Filter an NDJSON span export by trace: keep only traces with at
    least one span attributed to `backend` (handshake/connect spans
    carry attrs.backend), then only the LAST `limit` traces — newest
    claims are what an operator chasing a flagged backend wants. With
    neither filter the text passes through untouched (the default
    /kang/traces behaviour, byte-identical to the pre-filter surface).
    Whole traces are kept or dropped; span lines are never split up."""
    if not text or (limit is None and backend is None):
        return text
    groups: dict = {}
    order: list = []
    matched: set = set()
    for line in text.splitlines():
        if not line.strip():
            continue
        try:
            span = json.loads(line)
            tid = span.get('trace_id')
        except ValueError:
            tid = None
        if tid is None:
            continue
        if tid not in groups:
            groups[tid] = []
            order.append(tid)
        groups[tid].append(line)
        attrs = span.get('attrs')
        if backend is not None and isinstance(attrs, dict) and \
                attrs.get('backend') == backend:
            matched.add(tid)
    if backend is not None:
        order = [tid for tid in order if tid in matched]
    if limit is not None:
        limit = max(int(limit), 0)
        order = order[len(order) - limit:] if limit else []
    lines = [line for tid in order for line in groups[tid]]
    return '\n'.join(lines) + '\n' if lines else ''


# Identity of the current netsim scenario run (seed, name, schedule),
# attached by netsim.scenario so every export surface — summary(),
# the SIGUSR2 dump, kang snapshots — names the exact replayable run
# its numbers came from. Empty outside simulation.
_run_metadata: dict = {}


def set_run_metadata(meta: dict | None) -> None:
    global _run_metadata
    _run_metadata = dict(meta or {})


def get_run_metadata() -> dict:
    return dict(_run_metadata)


def summary() -> dict:
    runtime = _runtime
    if runtime is None:
        out = {'enabled': False}
    else:
        runtime._drain_native()
        out = {
            'enabled': True,
            'ring': len(runtime.tr_ring),
            'ring_size': runtime.tr_ring.maxlen,
            'sample_rate': runtime.tr_sample,
            'seen': runtime.tr_seen,
            'sampled': runtime.tr_sampled,
            'native': runtime.tr_native,
            'evicted': runtime.tr_evicted,
            'truncated': runtime.tr_truncated,
        }
        if runtime.tr_native:
            out['native_ring'] = dict(_native.trace_ring_stats())
    routers = _active_fleet_routers()
    if routers:
        out['shards'] = [r.snapshot() for r in routers]
    if _run_metadata:
        out['run'] = dict(_run_metadata)
    return out


def _active_fleet_routers() -> list:
    """Started FleetRouters, without importing the shard package until
    one could actually exist (it registers on start)."""
    import sys
    mod = sys.modules.get(__name__.rpartition('.')[0] + '.shard.router')
    if mod is None:
        return []
    return mod.active_routers()


def dump_traces(limit: int = 8) -> str:
    """Human-oriented section for the SIGUSR2 dump: the `limit` slowest
    completed traces with their per-span breakdown. '' when tracing is
    off or the ring is empty."""
    runtime = _runtime
    if runtime is None:
        return ''
    runtime._drain_native()
    if not runtime.tr_ring:
        return ''
    traces = sorted(runtime.tr_ring,
                    key=lambda t: t.root.duration() or 0.0,
                    reverse=True)[:limit]
    out = ['-- claim traces (%d slowest of %d in ring; '
           'sample_rate=%g) --' %
           (len(traces), len(runtime.tr_ring), runtime.tr_sample)]
    if runtime.tr_native:
        stats = _native.trace_ring_stats()
        out.append('  native ring: cap=%d pending=%d dropped=%d '
                   'highwater=%d truncated=%d' %
                   (stats['capacity'], stats['pending'],
                    stats['dropped'], stats['highwater'],
                    runtime.tr_truncated))
    for trace in traces:
        root = trace.root
        parts = ['%s=%.1f' % (name, ms)
                 for name, ms in sorted(trace.span_totals().items())]
        out.append('  %s %-10s %8.1fms %-9s %s' % (
            trace.trace_id[:8], root.name, root.duration() or 0.0,
            root.attrs.get('outcome', '?'), ' '.join(parts)))
    return '\n'.join(out) + '\n'
