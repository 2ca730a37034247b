"""Transport wire ledger: what happens *below* the Transport seam.

The claim phase ledger stops at an opaque ``socket_wait`` phase; this
module is the instrument that looks under it, three ways:

- The **TransportLedger** — per-(transport, seam) fixed-slot counters
  every backend feeds: connect/read/write syscall-equivalent counts,
  byte totals in both directions, readiness→callback dispatch latency
  and write-buffer highwater. The five seams are the Transport plug-in
  contract (``SEAMS`` mirrors ``transport.SEAM_METHODS``; ``make
  check`` pins the two together via cbflow A006), so the asyncio and
  fabric backends emit comparable counters and a future native
  backend has a conformance target (``trace.WIRE_EVENT_CODES`` are its
  reserved ring slots).

- The **loop-lag sampler** — a self-rescheduling timer per event loop
  measuring scheduled-vs-actual callback delta (the "is the loop
  saturated" signal), armed alongside the SIGPROF sampler on the debug
  signal and refusing to run under a non-system clock exactly like
  profile.start_sampler (netsim scenarios stay deterministic).

- The **socket_wait decomposition** — transports stamp wire marks
  (kernel readiness time, loop dispatch time) on each connection; the
  ledger keys them by the exact ``(start, end)`` floats of the connect
  span so profile.claim_ledger can split ``socket_wait`` into
  ``kernel_wait`` / ``loop_dispatch`` / ``proto_parse`` sub-phases
  without touching the trace ring's byte format.

Everything is off until :func:`enable_wiretap` installs the ledger;
disabled, every hook costs one module-global load and a None check
(the ``_prof`` seam discipline — the bench A/B gate holds the enabled
claim-path overhead under 1%). This package's copy of
``cueball_tpu.wiretap``; its loop-lag sampler also stops from another
thread than its loop's (a shard loop's sampler stopped from the main
thread), and ``host`` re-exports it for the fleet sampler.
Surfaces: ``GET /kang/transport``,
``cueball_transport_{bytes,events,dispatch_lag_ms,loop_lag_ms}`` on
/metrics (histograms fold under ``merge_expositions``), a section in
the SIGUSR2 dump, netsim failure dumps, and
:meth:`FleetRouter.wiretap_fleet` merging per-shard records via
:func:`reduce_wiretap`. See docs/transport.md §Wire ledger.
"""

from __future__ import annotations

import asyncio

from . import utils as mod_utils

__all__ = [
    'SEAMS',
    'SUB_PHASES',
    'PARITY_FIELDS',
    'SeamStats',
    'TransportLedger',
    'enable_wiretap',
    'disable_wiretap',
    'wiretap_enabled',
    'seam_stats',
    'watch',
    'instrument_writer',
    'record_connect',
    'wire_wait',
    'connect_breakdown',
    'snapshot',
    'wire_totals',
    'register_wire_source',
    'unregister_wire_source',
    'start_loop_lag_sampler',
    'stop_loop_lag_sampler',
    'loop_lag_stats',
    'loop_lag_p99_us',
    'wiretap_record',
    'reduce_wiretap',
    'dump_wiretap',
]

#: The five Transport seams, in display order. Membership is a
#: cross-module contract: transport.SEAM_METHODS must match exactly
#: (cbflow rule A006 pins both against the Transport class), and the
#: /kang/transport ``?seam=`` filter validates against this tuple.
SEAMS = ('connector', 'create_stream', 'serve', 'dns_udp', 'dns_tcp')

#: The socket_wait sub-phases, in display order. profile.claim_ledger
#: emits them under ``led['wire']`` holding
#: ``sum(SUB_PHASES) == phases['socket_wait']`` exactly per claim.
SUB_PHASES = ('kernel_wait', 'loop_dispatch', 'proto_parse')

#: SeamStats fields the asyncio-vs-fabric parity gate compares. The
#: latency/highwater fields are excluded (wall-clock vs virtual time),
#: and ``closes`` is excluded because the real-socket path suppresses
#: the 'close' emit on owner-initiated destroy while netsim emits it
#: (see docs/transport.md §Wire ledger).
PARITY_FIELDS = ('events', 'connects', 'errors', 'reads', 'writes',
                 'bytes_in', 'bytes_out')

# Connect-breakdown retention: (start, end) -> (kernel, dispatch,
# parse) entries kept for claim_ledger replay. Sized to comfortably
# cover the trace ring (claims outlive their connects rarely; 4096
# matches the trace assembler's pending cap).
_BREAKDOWN_CAP = 4096

DEFAULT_LAG_INTERVAL_MS = 20.0
DEFAULT_LAG_RING = 512


class SeamStats:
    """Fixed-slot counters for one (transport, seam) pair. All fields
    are plain ints/floats mutated in place from the hot path — no
    dict lookups, no allocation after construction."""

    __slots__ = ('events', 'connects', 'errors', 'closes', 'reads',
                 'writes', 'bytes_in', 'bytes_out', 'dispatch_count',
                 'dispatch_ms_total', 'dispatch_ms_max',
                 'buf_highwater')

    def __init__(self):
        self.events = 0            # seam invocations
        self.connects = 0          # successful connects / accepts
        self.errors = 0
        self.closes = 0
        self.reads = 0             # syscall-equivalent reads
        self.writes = 0            # syscall-equivalent writes
        self.bytes_in = 0
        self.bytes_out = 0
        self.dispatch_count = 0    # readiness->callback latencies seen
        self.dispatch_ms_total = 0.0
        self.dispatch_ms_max = 0.0
        self.buf_highwater = 0     # max write-buffer depth observed

    def as_dict(self) -> dict:
        return {name: getattr(self, name) for name in self.__slots__}


class TransportLedger:
    """The process-wide wire ledger. One instance lives at module
    scope while wiretap is enabled; transports fetch SeamStats through
    :func:`seam_stats` (None when disabled) so the disabled cost stays
    at a global load + None check."""

    def __init__(self, collector=None):
        self.collector = collector
        self._stats: dict = {}        # (transport, seam) -> SeamStats
        self._wire: dict = {}         # transport -> [kernel, disp, parse]
        self._breakdown: dict = {}    # (start, end) -> (k, d, p)
        self._breakdown_order: list = []
        # The ONE bound-method object registered as the collect hook:
        # remove_collect_hook compares by identity, and every
        # ``self._publish`` attribute access builds a fresh bound
        # method, so enable/disable must hand the collector the same
        # object.
        self._publish_hook = self._publish

    # -- counters --------------------------------------------------------

    def seam(self, transport: str, seam: str) -> SeamStats:
        st = self._stats.get((transport, seam))
        if st is None:
            if seam not in SEAMS:
                raise ValueError('unknown seam %r (one of %s)'
                                 % (seam, ', '.join(SEAMS)))
            st = self._stats[(transport, seam)] = SeamStats()
        return st

    # -- connect decomposition -------------------------------------------

    def record_connect(self, transport: str, start: float, end: float,
                       marks) -> None:
        """Fold one finished connect into the wire totals and retain
        its breakdown keyed by the exact (start, end) floats — the
        same values connection_fsm hands the tracer as the connect
        span, which is what lets claim_ledger find it again.

        ``marks`` is ``(ready, dispatched)`` — when the kernel
        reported the socket writable and when the awaiting coroutine
        actually resumed — or None (no protocol-level marks: the whole
        span counts as kernel_wait)."""
        if end < start:
            end = start
        if marks is None:
            kernel, dispatch, parse = end - start, 0.0, 0.0
        else:
            ready, dispatched = marks
            ready = min(max(ready, start), end)
            dispatched = min(max(dispatched, ready), end)
            kernel = ready - start
            dispatch = dispatched - ready
            parse = end - dispatched
        tot = self._wire.get(transport)
        if tot is None:
            tot = self._wire[transport] = [0.0, 0.0, 0.0]
        tot[0] += kernel
        tot[1] += dispatch
        tot[2] += parse
        key = (start, end)
        if key not in self._breakdown:
            if len(self._breakdown_order) >= _BREAKDOWN_CAP:
                old = self._breakdown_order.pop(0)
                self._breakdown.pop(old, None)
            self._breakdown_order.append(key)
        self._breakdown[key] = (kernel, dispatch, parse)
        if self.collector is not None and dispatch >= 0.0:
            self.collector.histogram(
                'cueball_transport_dispatch_lag_ms',
                'Kernel readiness to callback dispatch latency per '
                'transport connect (ms)').observe(
                    dispatch, {'transport': transport})

    def wire_wait(self, transport: str, kernel_ms: float) -> None:
        """Attribute a bare in-kernel wait (no dispatch marks — e.g.
        the claim-readiness probe dribbling segments) to a
        transport's kernel_wait total."""
        if kernel_ms <= 0.0:
            return
        tot = self._wire.get(transport)
        if tot is None:
            tot = self._wire[transport] = [0.0, 0.0, 0.0]
        tot[0] += kernel_ms

    def connect_breakdown(self, start: float, end: float):
        return self._breakdown.get((start, end))

    # -- export ----------------------------------------------------------

    def snapshot(self) -> dict:
        """``{transport: {seam: {field: value}}}`` for every seam that
        has recorded at least one event."""
        out: dict = {}
        for (transport, seam), st in sorted(self._stats.items()):
            out.setdefault(transport, {})[seam] = st.as_dict()
        return out

    def wire_totals(self) -> dict:
        return {t: dict(zip(SUB_PHASES, tot))
                for t, tot in sorted(self._wire.items())}

    def _publish(self) -> None:
        """Collect hook: fold current counters into gauges at scrape
        time (histograms are observed live; see record_connect and the
        lag sampler)."""
        collector = self.collector
        for (transport, seam), st in self._stats.items():
            labels = {'transport': transport, 'seam': seam}
            collector.gauge(
                'cueball_transport_events',
                'Seam invocations recorded by the transport wire '
                'ledger').set(st.events, labels)
            for direction, val in (('in', st.bytes_in),
                                   ('out', st.bytes_out)):
                collector.gauge(
                    'cueball_transport_bytes',
                    'Bytes moved per transport seam and direction'
                ).set(val, dict(labels, direction=direction))


# The module-global hot-path guard: None while disabled.
_LEDGER: TransportLedger | None = None


def enable_wiretap(collector=None) -> TransportLedger:
    """Install the process-wide TransportLedger (idempotent). With a
    metrics ``collector``, registers a collect hook publishing
    ``cueball_transport_{events,bytes}`` and observes the
    dispatch/loop-lag histograms as they happen."""
    global _LEDGER
    if _LEDGER is not None:
        return _LEDGER
    led = TransportLedger(collector=collector)
    if collector is not None:
        collector.add_collect_hook(led._publish_hook)
    _LEDGER = led
    return led


def disable_wiretap() -> bool:
    """Drop the ledger (counters are discarded). Returns whether one
    was installed."""
    global _LEDGER
    led = _LEDGER
    _LEDGER = None
    if led is None:
        return False
    if led.collector is not None:
        led.collector.remove_collect_hook(led._publish_hook)
    return True


def wiretap_enabled() -> bool:
    return _LEDGER is not None


def seam_stats(transport: str, seam: str):
    """The hot-path accessor: SeamStats for (transport, seam), or None
    while wiretap is disabled. Transports call this once per seam
    invocation and skip all accounting on None."""
    led = _LEDGER
    if led is None:
        return None
    return led.seam(transport, seam)


def watch(st: SeamStats, conn) -> None:
    """Attach outcome-counting listeners to a connection-contract
    object ('connect'/'error'/'close'). Listeners are marked
    framework-internal so the claim-handle leak detector and the
    listener mutation epoch ignore them."""

    def on_connect():
        st.connects += 1

    def on_error(err=None):
        st.errors += 1

    def on_close():
        st.closes += 1

    on_connect._cueball_internal = True
    on_error._cueball_internal = True
    on_close._cueball_internal = True
    conn.on('connect', on_connect)
    conn.on('error', on_error)
    conn.on('close', on_close)


def instrument_writer(st: SeamStats, writer) -> None:
    """Shadow ``writer.write`` with a counting wrapper (writes,
    bytes_out, write-buffer highwater). Instance-attribute shadowing,
    not subclassing: the StreamWriter is already built by the time the
    connect path knows wiretap is on."""
    inner = writer.write
    transport = writer.transport

    def write(data):
        st.writes += 1
        st.bytes_out += len(data)
        inner(data)
        try:
            depth = transport.get_write_buffer_size()
        except Exception:
            return
        if depth > st.buf_highwater:
            st.buf_highwater = depth

    writer.write = write


def record_connect(transport: str, start: float, end: float,
                   marks) -> None:
    """Module-level forwarder used by connection_fsm (one global load
    + None check when disabled)."""
    led = _LEDGER
    if led is not None:
        led.record_connect(transport, start, end, marks)


def wire_wait(transport: str, kernel_ms: float) -> None:
    led = _LEDGER
    if led is not None:
        led.wire_wait(transport, kernel_ms)


def connect_breakdown(start: float, end: float):
    """(kernel, dispatch, parse) ms for the connect span keyed by the
    exact (start, end) floats, or None (wiretap off, span evicted, or
    connect predates enable)."""
    led = _LEDGER
    if led is None:
        return None
    return led.connect_breakdown(start, end)


#: Pull hooks for backends that count wire traffic out-of-band (the
#: native C data plane folds its atomic counters into the ledger on
#: demand). Called before every module-level snapshot/wire_totals
#: read so readers never see stale native rows.
_WIRE_SOURCES: list = []


def register_wire_source(pull) -> None:
    """Register a zero-arg callable that folds externally-counted
    wire traffic into the live ledger; invoked before snapshot() and
    wire_totals(). Idempotent per callable."""
    if pull not in _WIRE_SOURCES:
        _WIRE_SOURCES.append(pull)


def unregister_wire_source(pull) -> bool:
    try:
        _WIRE_SOURCES.remove(pull)
        return True
    except ValueError:
        return False


def _pull_wire_sources() -> None:
    for pull in list(_WIRE_SOURCES):
        pull()


def snapshot() -> dict:
    led = _LEDGER
    if led is None:
        return {}
    _pull_wire_sources()
    return led.snapshot()


def wire_totals() -> dict:
    led = _LEDGER
    if led is None:
        return {}
    _pull_wire_sources()
    return led.wire_totals()


# -- loop-lag sampler --------------------------------------------------------

class _LoopLagSampler:
    __slots__ = ('loop', 'interval_s', 'ring', 'samples', 'count',
                 'max_us', 'handle', 'stopped')

    def __init__(self, loop, interval_s: float, ring: int):
        self.loop = loop
        self.interval_s = interval_s
        self.ring = ring
        self.samples: list = []     # lag in us, overwrite-oldest
        self.count = 0
        self.max_us = 0.0
        self.handle = None
        self.stopped = False

    def _arm(self) -> None:
        expected = self.loop.time() + self.interval_s
        self.handle = self.loop.call_later(
            self.interval_s, self._fire, expected)

    def _fire(self, expected: float) -> None:
        if self.stopped:
            return
        lag_us = max(0.0, (self.loop.time() - expected) * 1e6)
        if len(self.samples) >= self.ring:
            del self.samples[0]
        self.samples.append(lag_us)
        self.count += 1
        if lag_us > self.max_us:
            self.max_us = lag_us
        led = _LEDGER
        if led is not None and led.collector is not None:
            led.collector.histogram(
                'cueball_transport_loop_lag_ms',
                'Scheduled-vs-actual event loop callback delta '
                '(ms)').observe(lag_us / 1000.0)
        self._arm()

    def stop(self) -> None:
        """Disarm. From another thread than the loop's, the timer is
        cancelled on the loop; the flag alone already stops it."""
        self.stopped = True
        handle, self.handle = self.handle, None
        if handle is None:
            return
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is self.loop:
            handle.cancel()
        elif not self.loop.is_closed():
            self.loop.call_soon_threadsafe(handle.cancel)

    def stats(self) -> dict:
        ordered = sorted(self.samples)
        n = len(ordered)

        def pct(q):
            if n == 0:
                return 0.0
            return ordered[min(n - 1, int(q * n))]

        return {
            'running': not self.stopped,
            'samples': self.count,
            'ring': self.ring,
            'p50_us': pct(0.50),
            'p99_us': pct(0.99),
            'max_us': self.max_us,
        }


_lag_samplers: dict = {}          # id(loop) -> _LoopLagSampler
_lag_disabled_reason: str | None = None


def start_loop_lag_sampler(interval_ms: float = DEFAULT_LAG_INTERVAL_MS,
                           ring: int = DEFAULT_LAG_RING) -> bool:
    """Arm the loop-lag sampler on the current running loop
    (idempotent per loop). Refuses — recording why in
    loop_lag_stats()['disabled_reason'] — under a non-system clock
    (netsim must stay deterministic; a timer firing "late" in virtual
    time is meaningless) or when no loop is running here."""
    global _lag_disabled_reason
    if not isinstance(mod_utils.get_clock(), mod_utils.SystemClock):
        _lag_disabled_reason = 'non-system clock installed (netsim?)'
        return False
    try:
        loop = asyncio.get_running_loop()
    except RuntimeError:
        _lag_disabled_reason = 'no running event loop'
        return False
    key = id(loop)
    sampler = _lag_samplers.get(key)
    if sampler is not None and not sampler.stopped:
        return True
    sampler = _LoopLagSampler(loop, max(0.001, interval_ms / 1000.0),
                              int(ring))
    _lag_samplers[key] = sampler
    sampler._arm()
    _lag_disabled_reason = None
    return True


def stop_loop_lag_sampler() -> bool:
    """Disarm every armed loop sampler (collected stats survive until
    the next start on the same loop). Returns whether any was
    running."""
    any_running = False
    for sampler in list(_lag_samplers.values()):
        if not sampler.stopped:
            any_running = True
            sampler.stop()
    return any_running


def _current_sampler():
    try:
        loop = asyncio.get_running_loop()
    except RuntimeError:
        loop = None
    if loop is not None:
        sampler = _lag_samplers.get(id(loop))
        if sampler is not None:
            return sampler
    if len(_lag_samplers) == 1:
        return next(iter(_lag_samplers.values()))
    return None


def loop_lag_stats() -> dict:
    """Lag stats for the current loop's sampler when there is one,
    else the worst-case merge across all sampled loops."""
    sampler = _current_sampler()
    if sampler is not None:
        out = sampler.stats()
    elif _lag_samplers:
        merged = [s.stats() for s in _lag_samplers.values()]
        out = {
            'running': any(m['running'] for m in merged),
            'samples': sum(m['samples'] for m in merged),
            'ring': max(m['ring'] for m in merged),
            'p50_us': max(m['p50_us'] for m in merged),
            'p99_us': max(m['p99_us'] for m in merged),
            'max_us': max(m['max_us'] for m in merged),
        }
    else:
        out = {'running': False, 'samples': 0, 'ring': 0,
               'p50_us': 0.0, 'p99_us': 0.0, 'max_us': 0.0}
    out['disabled_reason'] = _lag_disabled_reason
    return out


def loop_lag_p99_us() -> float:
    """The FleetSampler telemetry column: current-loop lag p99 in us
    (0.0 when no sampler is armed here) — one dict lookup plus a
    sort of at most `ring` floats, called once per O(dirty) patch
    pass, not per row."""
    sampler = _current_sampler()
    if sampler is None:
        return 0.0
    ordered = sorted(sampler.samples)
    n = len(ordered)
    if n == 0:
        return 0.0
    return ordered[min(n - 1, int(0.99 * n))]


# -- fleet merge (FleetRouter.wiretap_fleet) ---------------------------------

def wiretap_record(shard: int | None = None) -> dict:
    """One shard's mergeable wiretap record. The TransportLedger is
    process-global (thread-backend shards share it), so the per-shard
    payload is the loop-local part: that shard loop's lag stats."""
    return {
        'shard': shard,
        'enabled': _LEDGER is not None,
        'loop_lag': loop_lag_stats(),
    }


def reduce_wiretap(records) -> dict:
    """Merge per-shard wiretap records shard -> host, the reduction
    shape of reduce_profile: lag folds worst-case (a single saturated
    loop is the signal), the shared transport counters ride along
    once, and the per-shard records are retained."""
    records = [r for r in records if r]
    return {
        'n_shards': len(records),
        'enabled': _LEDGER is not None,
        'loop_lag_p99_us': max(
            (r.get('loop_lag', {}).get('p99_us', 0.0)
             for r in records), default=0.0),
        'loop_lag_samples': sum(
            r.get('loop_lag', {}).get('samples', 0) for r in records),
        'transports': snapshot(),
        'wire_ms': wire_totals(),
        'shards': records,
    }


# -- SIGUSR2 dump section ----------------------------------------------------

def dump_wiretap() -> str:
    """Wire-ledger section for the SIGUSR2 dump; '' when wiretap was
    never enabled and no lag sampler ever armed, so the dump stays
    absent-but-well-formed."""
    led = _LEDGER
    lag = loop_lag_stats()
    if led is None and not _lag_samplers and not _lag_disabled_reason:
        return ''
    out = ['-- transport wire ledger --']
    out.append('  wiretap: %s' %
               ('enabled' if led is not None else 'disabled'))
    if lag['disabled_reason']:
        out.append('  loop lag: disabled (%s)' % lag['disabled_reason'])
    else:
        out.append('  loop lag: samples=%d p50=%.0fus p99=%.0fus '
                   'max=%.0fus%s' % (lag['samples'], lag['p50_us'],
                                     lag['p99_us'], lag['max_us'],
                                     '' if lag['running']
                                     else ' (stopped)'))
    if led is not None:
        for transport, seams in led.snapshot().items():
            for seam, st in seams.items():
                out.append('  %s/%s: events=%d connects=%d errors=%d '
                           'reads=%d writes=%d in=%dB out=%dB '
                           'highwater=%d' % (
                               transport, seam, st['events'],
                               st['connects'], st['errors'],
                               st['reads'], st['writes'],
                               st['bytes_in'], st['bytes_out'],
                               st['buf_highwater']))
        for transport, tot in led.wire_totals().items():
            out.append('  wire %s: kernel_wait=%.1fms '
                       'loop_dispatch=%.1fms proto_parse=%.1fms' % (
                           transport, tot['kernel_wait'],
                           tot['loop_dispatch'], tot['proto_parse']))
    return '\n'.join(out) + '\n'
