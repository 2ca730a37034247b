"""Continuous claim-path profiler: phase ledger + sampling flamegraphs;
this package's copy of the JAX package's ``profile``.

Two instruments over one substrate, answering "where do a claim's
microseconds go" with zero new hot-path instrumentation:

- The **phase ledger** replays the trace ring's completed claim spans
  (trace.py already records them for /kang/traces) into per-claim time
  accounting across the named claim phases — queue wait, CoDel pacing,
  runq pump, FSM transitions, socket wait, handshake, lease — holding
  a ``phase_sum ≈ wall`` invariant per claim. Ledger numbers are pure
  replay arithmetic: deterministic under netsim, and free when nobody
  asks.

- The **sampling profiler** attributes CPU time *within* those phases:
  a SIGPROF handler (``signal.setitimer`` + frame inspection) appends
  (phase, site, t) samples to a bounded overwrite-oldest ring, reading
  a phase tag that the engine modules' ``_prof`` seams push around the
  work whose code cannot be told from its frame (the CoDel pacer, the
  connect initiation). This package has no native emitter, so this is
  the only engine, the one the JAX package runs under
  ``CUEBALL_NO_NATIVE``. The sampler refuses to arm under a substituted
  clock (netsim VirtualClock) so simulated scenarios stay
  deterministic.

Surfaces: collapsed-stack flamegraph text at ``GET /kang/profile``,
``cueball_claim_phase_ms{phase=...}`` histograms on /metrics, a
profiler section in the SIGUSR2 dump (:func:`dump_profile`),
netsim failure dumps embedding the ledger of the slowest claims, and
:meth:`shard.FleetRouter.profile_fleet` merging per-shard records
(:func:`reduce_profile`) like ``reduce_health``.
"""

from __future__ import annotations

import signal
import sys

from . import trace as mod_trace
from . import utils as mod_utils
from . import wiretap as mod_wiretap

__all__ = [
    'PHASES',
    'SUB_PHASES',
    'claim_ledger',
    'phase_ledger',
    'ledger_summary',
    'profile_record',
    'reduce_profile',
    'flamegraph',
    'start_sampler',
    'stop_sampler',
    'sampler_running',
    'sampler_stats',
    'dump_profile',
]

#: The named claim phases, in ledger/flamegraph display order. Order
#: and membership are a cross-surface contract: the sampler's phase
#: ids map into this tuple via _PHASE_BY_ID, and the
#: cueball_claim_phase_ms histogram label values are drawn from it.
PHASES = ('queue_wait', 'codel', 'runq_pump', 'fsm',
          'socket_wait', 'handshake', 'lease', 'other')

#: socket_wait sub-phases (re-exported from wiretap, the module that
#: defines them): where the opaque socket_wait phase actually went —
#: in-kernel readiness wait, event-loop dispatch lag, or Python
#: protocol/constructor work. They live in ``led['wire']``, NOT in
#: ``led['phases']``: PHASES membership is the sampler / histogram
#: label contract and the ``sum(phases) == wall`` identity stays on
#: the eight named phases, while ``sum(led['wire'].values()) ==
#: phases['socket_wait']`` holds exactly per claim.
SUB_PHASES = mod_wiretap.SUB_PHASES

# Sampler phase id -> phase name (the JAX package's C PROF_PHASE_*
# numbering, kept so sample records read alike in both packages).
_PHASE_BY_ID = ('other', 'queue_wait', 'codel', 'runq_pump', 'fsm',
                'socket_wait', 'handshake', 'lease')
_PHASE_IDS = {name: i for i, name in enumerate(_PHASE_BY_ID)}

DEFAULT_INTERVAL_MS = 5.0
DEFAULT_SAMPLER_RING = 8192

# Flamegraph weights are integer microseconds (collapsed-stack format
# wants integer counts); sampler stacks are weighted by sample count.
_US_PER_MS = 1000


# -- phase ledger -----------------------------------------------------------

def claim_ledger(trace) -> dict | None:
    """Per-claim time accounting across :data:`PHASES` (all ms).

    Derived entirely from the claim's recorded spans, which are
    contiguous by construction (queue_wait ends where the handshake
    begins, the handshake ends where the lease begins, the lease ends
    at release; Trace.finish closes stragglers at the root end), so
    ``sum(phases) == wall`` up to float addition and ``coverage`` —
    the named share of wall time — sits at ~1.0 on both the fast and
    queued paths. ``socket_wait`` is the during-claim part of the
    connect span and is carved OUT of queue_wait (the claim queues
    while its socket connects) so the phases stay disjoint. The
    ``codel``/``runq_pump``/``fsm`` columns are sampler-attributed
    phases: the ledger carries them (non-null, 0.0) so every surface
    shows the full phase set, and the flamegraph's sampler stacks say
    where their CPU went. Returns None for a trace still open or not
    a claim."""
    root = trace.root
    if root.end is None or root.attrs.get('kind') != 'claim':
        return None
    wall = root.end - root.start
    queue_wait = handshake = lease = socket_wait = 0.0
    connect_parts = []
    for span in trace.spans[1:]:
        d = span.duration()
        if d is None:
            continue
        if span.name == 'queue_wait':
            queue_wait += d
        elif span.name == 'handshake':
            handshake += d
        elif span.name == 'lease':
            lease += d
        elif span.name == 'connect' and span.attrs.get('during_claim'):
            # Only the part inside the claim window counts against it.
            part = max(
                0.0, min(span.end, root.end) - max(span.start,
                                                   root.start))
            socket_wait += part
            if part > 0.0:
                connect_parts.append((span.start, span.end, part))
    socket_wait = min(socket_wait, queue_wait)
    queue_wait -= socket_wait
    phases = {
        'queue_wait': queue_wait,
        'codel': 0.0,
        'runq_pump': 0.0,
        'fsm': 0.0,
        'socket_wait': socket_wait,
        'handshake': handshake,
        'lease': lease,
    }
    named = sum(phases.values())
    phases['other'] = max(wall - named, 0.0)
    wire, decomposed = _decompose_socket_wait(socket_wait,
                                              connect_parts)
    return {
        'trace_id': trace.trace_id,
        'wire': wire,
        'wire_decomposed': decomposed,
        'pool': root.attrs.get('pool', ''),
        'domain': root.attrs.get('domain', ''),
        'shard': root.attrs.get('shard'),
        'backend': getattr(trace, 'ct_backend', '') or '',
        'outcome': root.attrs.get('outcome', '?'),
        'wall_ms': wall,
        'phases': phases,
        'coverage': (named / wall) if wall > 0.0 else 1.0,
    }


def _decompose_socket_wait(socket_wait: float, connect_parts) -> tuple:
    """Split one claim's socket_wait across :data:`SUB_PHASES` using
    the wiretap ledger's per-connect breakdowns (keyed by the exact
    connect-span floats). Returns ``(wire_dict, decomposed)``;
    without wiretap data the whole phase is attributed to kernel_wait
    (``decomposed`` False). The returned values are nudged so
    ``kernel_wait + loop_dispatch + proto_parse == socket_wait`` holds
    under plain float addition — the per-claim identity the parity
    and scenario gates assert with ``==``."""
    if socket_wait > 0.0 and connect_parts and \
            mod_wiretap._LEDGER is not None:
        kernel = dispatch = parse = 0.0
        found = False
        for start, end, part in connect_parts:
            bk = mod_wiretap._LEDGER.connect_breakdown(start, end)
            if bk is None:
                continue
            span_len = end - start
            f = (part / span_len) if span_len > 0.0 else 0.0
            kernel += bk[0] * f
            dispatch += bk[1] * f
            parse += bk[2] * f
            found = True
        total = kernel + dispatch + parse
        if found and total > 0.0:
            scale = socket_wait / total
            kernel *= scale
            dispatch *= scale
            parse = socket_wait - kernel - dispatch
            if parse < 0.0:
                kernel += parse
                parse = 0.0
            if kernel + dispatch + parse != socket_wait:
                kernel = socket_wait - dispatch - parse
            if kernel < 0.0 or \
                    kernel + dispatch + parse != socket_wait:
                kernel, dispatch, parse = socket_wait, 0.0, 0.0
            return ({'kernel_wait': kernel,
                     'loop_dispatch': dispatch,
                     'proto_parse': parse}, True)
    return ({'kernel_wait': socket_wait, 'loop_dispatch': 0.0,
             'proto_parse': 0.0}, False)


def phase_ledger(traces=None) -> list:
    """Ledgers for every completed claim in `traces` (default: the
    live trace ring), oldest first."""
    if traces is None:
        traces = mod_trace.trace_ring()
    out = []
    for trace in traces:
        led = claim_ledger(trace)
        if led is not None:
            out.append(led)
    return out


def ledger_summary(ledgers) -> dict:
    """Fold per-claim ledgers into one cost-attribution record:
    total wall, per-phase totals, the wall-weighted coverage, and the
    socket_wait wire sub-phase totals (``wire_ms``/``wire_claims``
    fold only claims the wiretap ledger actually decomposed, so the
    undecomposed remainder stays visibly in the opaque parent
    phase)."""
    phase_ms = {p: 0.0 for p in PHASES}
    wire_ms = {p: 0.0 for p in SUB_PHASES}
    wire_claims = 0
    wall = 0.0
    named = 0.0
    n = 0
    for led in ledgers:
        n += 1
        wall += led['wall_ms']
        for p, ms in led['phases'].items():
            phase_ms[p] = phase_ms.get(p, 0.0) + ms
        if led.get('wire_decomposed'):
            wire_claims += 1
            for p, ms in led['wire'].items():
                wire_ms[p] = wire_ms.get(p, 0.0) + ms
        named += led['wall_ms'] * led['coverage']
    return {
        'claims': n,
        'wall_ms': wall,
        'phase_ms': phase_ms,
        'wire_ms': wire_ms,
        'wire_claims': wire_claims,
        'coverage': (named / wall) if wall > 0.0 else 1.0,
    }


# -- fleet merge (FleetRouter.profile_fleet) --------------------------------

def profile_record(shard: int | None = None) -> dict:
    """One shard's (or the whole process's) mergeable profile record.

    With `shard` set, only claims stamped with that shard id count —
    thread-backend shards share one process-wide trace ring, so the
    filter is what keeps per-shard records disjoint. Spawn-backend
    children call this in their own process (their ring IS the
    shard's) and still pass their id so the record is labelled."""
    ledgers = phase_ledger()
    if shard is not None:
        ledgers = [led for led in ledgers
                   if led['shard'] is None or led['shard'] == shard]
    rec = ledger_summary(ledgers)
    rec['shard'] = shard
    rec['sampler'] = sampler_stats()
    return rec


def reduce_profile(records) -> dict:
    """Merge per-shard profile records shard -> host, the same
    reduction shape as health.reduce_health: totals sum, coverage is
    re-derived wall-weighted, and the per-shard records ride along."""
    records = [r for r in records if r]
    phase_ms = {p: 0.0 for p in PHASES}
    wire_ms = {p: 0.0 for p in SUB_PHASES}
    wire_claims = 0
    wall = 0.0
    named = 0.0
    claims = 0
    for rec in records:
        claims += rec.get('claims', 0)
        wall += rec.get('wall_ms', 0.0)
        for p, ms in (rec.get('phase_ms') or {}).items():
            phase_ms[p] = phase_ms.get(p, 0.0) + ms
        for p, ms in (rec.get('wire_ms') or {}).items():
            wire_ms[p] = wire_ms.get(p, 0.0) + ms
        wire_claims += rec.get('wire_claims', 0)
        named += rec.get('wall_ms', 0.0) * rec.get('coverage', 0.0)
    return {
        'n_shards': len(records),
        'claims': claims,
        'wall_ms': wall,
        'phase_ms': phase_ms,
        'wire_ms': wire_ms,
        'wire_claims': wire_claims,
        'coverage': (named / wall) if wall > 0.0 else 1.0,
        'shards': records,
    }


# -- sampling profiler ------------------------------------------------------

# Accumulated samples: (phase, site) -> count. Fed by _collect_samples;
# survives sampler stop so the flamegraph covers the whole profiled
# window.
_samples: dict = {}
_sample_total = 0
_sampler_engine: str | None = None   # 'pure' | None
_disabled_reason: str | None = None
_pure_ring: list = []
_pure_cap = DEFAULT_SAMPLER_RING
_pure_dropped = 0
_pure_prev_handler = None

# Phase hint for the sampler, and the seam the engine modules use for
# the phases a frame cannot tell (pool.py's CoDel pacer,
# connection_fsm's connect initiation): while the sampler runs, those
# modules' `_prof` global points at this module and they bracket their
# work with push_phase/pop_phase; stopped, they pay one global load +
# None check.
_pure_hint = _PHASE_IDS['other']

# Modules that carry a `_prof` seam, named from this package's own
# name (never another package's copy of them); bound lazily at sampler
# start so importing profile never drags the whole engine in.
_PACKAGE = __name__.rpartition('.')[0]
_SEAM_MODULES = tuple('%s.%s' % (_PACKAGE, name) for name in
                      ('pool', 'connection_fsm', 'runq', 'fsm'))


def push_phase(name: str) -> int:
    """Tag the engine phase for subsequent samples; returns the
    previous tag for pop_phase."""
    global _pure_hint
    phase = _PHASE_IDS[name]
    prev = _pure_hint
    _pure_hint = phase
    return prev


def pop_phase(token: int) -> None:
    global _pure_hint
    _pure_hint = token


def _pure_sigprof(signum, frame):
    """The SIGPROF handler: attribute the sample to the explicit phase
    hint when one is pushed, else by the interrupted frame's module
    (runq -> runq_pump, fsm engines -> fsm, the selector poll ->
    socket_wait)."""
    global _pure_dropped
    phase = _pure_hint
    site = 'engine'
    if frame is not None:
        fname = frame.f_code.co_filename
        site = frame.f_code.co_name
        if phase == _PHASE_IDS['other']:
            if fname.endswith('runq.py'):
                phase = _PHASE_IDS['runq_pump']
            elif fname.endswith(('fsm.py', 'connection_fsm.py')):
                phase = _PHASE_IDS['fsm']
            elif 'selectors' in fname or site == 'select':
                phase = _PHASE_IDS['socket_wait']
    if len(_pure_ring) >= _pure_cap:
        del _pure_ring[0]
        _pure_dropped += 1
    _pure_ring.append((phase, site, mod_utils.current_millis()))


def _bind_seams(value) -> None:
    for name in _SEAM_MODULES:
        mod = sys.modules.get(name)
        if mod is not None and hasattr(mod, '_prof'):
            mod._prof = value


def start_sampler(interval_ms: float = DEFAULT_INTERVAL_MS,
                  ring: int = DEFAULT_SAMPLER_RING) -> bool:
    """Arm the SIGPROF sampler. Returns False (and records why in
    sampler_stats()['disabled_reason']) instead of arming when a
    non-system clock is installed — netsim scenarios must stay
    deterministic, and profiling virtual time is meaningless — or when
    the platform can't deliver the signal here (non-main thread)."""
    global _sampler_engine, _disabled_reason, _pure_cap, \
        _pure_prev_handler
    if _sampler_engine is not None:
        return True
    if not isinstance(mod_utils.get_clock(), mod_utils.SystemClock):
        _disabled_reason = 'non-system clock installed (netsim?)'
        return False
    try:
        _pure_prev_handler = signal.signal(signal.SIGPROF, _pure_sigprof)
        signal.setitimer(signal.ITIMER_PROF, interval_ms / 1000.0,
                         interval_ms / 1000.0)
    except (ValueError, OSError) as e:
        _disabled_reason = 'cannot arm SIGPROF here (%s)' % e
        return False
    _pure_cap = int(ring)
    _sampler_engine = 'pure'
    _disabled_reason = None
    _bind_seams(sys.modules[__name__])
    return True


def stop_sampler() -> bool:
    """Disarm the sampler, folding pending samples into the
    accumulated flamegraph counts. Returns whether it was running."""
    global _sampler_engine, _pure_prev_handler
    if _sampler_engine is None:
        return False
    _bind_seams(None)
    try:
        signal.setitimer(signal.ITIMER_PROF, 0.0)
        if _pure_prev_handler is not None:
            signal.signal(signal.SIGPROF, _pure_prev_handler)
    except (ValueError, OSError):
        pass
    _pure_prev_handler = None
    _collect_samples()
    _sampler_engine = None
    return True


def sampler_running() -> bool:
    return _sampler_engine is not None


def _collect_samples() -> None:
    """Drain the ring into the accumulated (phase, site) counts."""
    global _sample_total
    raw, _pure_ring[:] = list(_pure_ring), []
    for phase_id, site, _t in raw:
        key = (_PHASE_BY_ID[phase_id]
               if phase_id < len(_PHASE_BY_ID) else 'other', str(site))
        _samples[key] = _samples.get(key, 0) + 1
        _sample_total += 1


def sampler_stats() -> dict:
    out = {
        'running': _sampler_engine is not None,
        'engine': _sampler_engine,
        'samples': _sample_total,
        'disabled_reason': _disabled_reason,
    }
    if _sampler_engine == 'pure':
        out['ring'] = {'capacity': _pure_cap,
                       'pending': len(_pure_ring),
                       'dropped': _pure_dropped,
                       'running': True}
    return out


def reset_samples() -> None:
    """Drop accumulated sample counts (bench arms start clean)."""
    global _sample_total, _pure_dropped
    _collect_samples()
    _samples.clear()
    _sample_total = 0
    _pure_dropped = 0


# -- flamegraph -------------------------------------------------------------

def flamegraph(traces=None) -> str:
    """Collapsed-stack flamegraph text (the /kang/profile payload).

    Ledger stacks first — ``claim;<phase> <microseconds>`` in fixed
    PHASES order, zero phases skipped — then, only when the sampler
    has actually collected samples, ``sampler;<phase>;<site> <count>``
    stacks sorted by phase order then site. The ledger half is pure
    span replay, so on a seeded netsim run (where the sampler is
    auto-disabled) the output is byte-identical run to run."""
    total = ledger_summary(phase_ledger(traces))
    out = []
    for phase in PHASES:
        ms = total['phase_ms'].get(phase, 0.0)
        if phase == 'socket_wait' and total.get('wire_claims', 0) > 0:
            # Wiretap decomposed at least one claim: nest the wire
            # sub-phases under the parent frame, keeping only the
            # undecomposed remainder on the parent line. With wiretap
            # off this branch never runs and the output stays
            # byte-identical to the un-decomposed format.
            wire = total['wire_ms']
            residual = ms - sum(wire.values())
            us = int(round(max(residual, 0.0) * _US_PER_MS))
            if us > 0:
                out.append('claim;%s %d' % (phase, us))
            for sub in SUB_PHASES:
                sub_us = int(round(wire.get(sub, 0.0) * _US_PER_MS))
                if sub_us > 0:
                    out.append('claim;%s;%s %d' % (phase, sub, sub_us))
            continue
        us = int(round(ms * _US_PER_MS))
        if us > 0:
            out.append('claim;%s %d' % (phase, us))
    _collect_samples()
    if _samples:
        order = {p: i for i, p in enumerate(PHASES)}
        for (phase, site), count in sorted(
                _samples.items(),
                key=lambda kv: (order.get(kv[0][0], 99), kv[0][1])):
            out.append('sampler;%s;%s %d' % (phase, site, count))
    return '\n'.join(out) + '\n' if out else ''


# -- SIGUSR2 dump section ---------------------------------------------------

def dump_profile(limit: int = 5) -> str:
    """Profiler section for the SIGUSR2 dump: sampler state, the
    fleet-wide cost attribution, and the slowest claims' ledgers.
    '' when there is nothing to report (sampler never armed and no
    completed claims) so the dump stays absent-but-well-formed."""
    ledgers = phase_ledger()
    if not ledgers and _sampler_engine is None and not _samples:
        return ''
    out = ['-- claim-path profiler --']
    stats = sampler_stats()
    if stats['running']:
        ring = stats.get('ring') or {}
        out.append('  sampler: running engine=%s samples=%d '
                   'ring_pending=%s dropped=%s' %
                   (stats['engine'], stats['samples'],
                    ring.get('pending', '?'), ring.get('dropped', '?')))
    elif stats['disabled_reason']:
        out.append('  sampler: disabled (%s)' %
                   stats['disabled_reason'])
    else:
        out.append('  sampler: stopped samples=%d' % stats['samples'])
    if ledgers:
        total = ledger_summary(ledgers)
        parts = ['%s=%.1f' % (p, total['phase_ms'][p])
                 for p in PHASES if total['phase_ms'][p] > 0.0]
        out.append('  ledger: %d claims wall=%.1fms coverage=%.3f %s'
                   % (total['claims'], total['wall_ms'],
                      total['coverage'], ' '.join(parts)))
        if total.get('wire_claims', 0) > 0:
            out.append('  socket_wait wire: %s (%d claims decomposed)'
                       % (' '.join('%s=%.1f' % (p, total['wire_ms'][p])
                                   for p in SUB_PHASES),
                          total['wire_claims']))
        slow = sorted(ledgers, key=lambda led: led['wall_ms'],
                      reverse=True)[:limit]
        for led in slow:
            parts = ['%s=%.1f' % (p, led['phases'][p])
                     for p in PHASES if led['phases'][p] > 0.0]
            out.append('    %s %8.1fms %-9s %s' % (
                led['trace_id'][:8], led['wall_ms'], led['outcome'],
                ' '.join(parts)))
    if _samples:
        top = sorted(_samples.items(), key=lambda kv: -kv[1])[:limit]
        out.append('  top sample sites: ' + ' '.join(
            '%s;%s=%d' % (p, s, c) for (p, s), c in top))
    return '\n'.join(out) + '\n'
