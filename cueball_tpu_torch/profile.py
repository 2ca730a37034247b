"""The phase ledger of the JAX package's claim-path profiler
(``cueball_tpu.profile``): per-claim time accounting replayed from a
claim's recorded spans, which ``trace`` folds into the
``cueball_claim_phase_ms`` histogram, and its fold over many claims
(:func:`phase_ledger`, :func:`ledger_summary`), which netsim's failure
dumps embed. Pure replay arithmetic: no clock or RNG reads.

This package's copy holds the ledger only. The sampling profiler
(SIGPROF, flamegraphs, ``GET /kang/profile``) is not ported yet.
"""

from __future__ import annotations

from . import trace as mod_trace
from . import wiretap as mod_wiretap

__all__ = ['PHASES', 'SUB_PHASES', 'claim_ledger', 'phase_ledger',
           'ledger_summary']

#: The named claim phases, in ledger display order; the
#: cueball_claim_phase_ms histogram's label values are drawn from it.
PHASES = ('queue_wait', 'codel', 'runq_pump', 'fsm',
          'socket_wait', 'handshake', 'lease', 'other')

#: socket_wait sub-phases (re-exported from wiretap, the module that
#: defines them). They live in ``led['wire']``, not in
#: ``led['phases']``: ``sum(phases) == wall`` stays on the eight named
#: phases, while ``sum(led['wire'].values()) == phases['socket_wait']``
#: holds exactly per claim.
SUB_PHASES = mod_wiretap.SUB_PHASES


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
