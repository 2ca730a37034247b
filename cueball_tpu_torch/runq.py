"""Single-pump engine run queue (setImmediate-phase analogue).

Every deferral the FSM engine issues — gated ``S.immediate``
callbacks, deferred ``stateChanged`` emissions, the claim path's
``try_next``/requeue hops, the cset stopping drain — used to be its
own ``loop.call_soon``, and each one paid a full asyncio ``Handle`` +
contextvars ``Context.run`` round trip (~13% of a claim/release cycle,
docs/claim-path-profile.md round 5). ``defer()`` instead pushes one
entry onto a per-loop FIFO and schedules at most ONE pump callback per
loop tick to drain it: N deferrals per tick cost one Handle/Context,
the way node batches the whole ``setImmediate`` phase for the
reference.

Ordering contract (the iteration-boundary semantics of node's
setImmediate phase):

- entries drain in push order — engine deferrals stay FIFO among
  themselves, and against plain user ``call_soon`` callbacks the burst
  occupies the loop slot of its FIRST deferral (a user callback
  scheduled before the burst runs before it, one scheduled after the
  burst runs after it; a callback scheduled mid-burst observes the
  batch as one unit, exactly node's setImmediate-phase behaviour);
- the drain only delivers the entries present when it starts: pushes
  made DURING a drain open a fresh batch drained by a new pump on the
  NEXT loop iteration, never the same drain — same-tick execution
  would collapse the reference's two-loop-tick claim cycle
  (lib/pool.js:859-969 semantics);
- a raising entry is routed to ``loop.call_exception_handler`` and the
  rest of the batch still drains, matching how an exception in an
  individual ``call_soon`` callback behaves.

``set_pump_enabled(False)`` (or ``CUEBALL_NO_PUMP=1`` at import)
drops back to the reference's literal scheduling — one ``call_soon``
per deferral, including each deferred ``stateChanged`` emission —
which is what the interleaved off/on/off bench A/B (bench.py
``bench_pump_ab``) measures against. Engine-deferral ordering is
identical in both modes (the conformance suite pins a byte-identical
pool transition trace across them); only the scheduling cost
changes.

The native engine implements the same queue in C
(native/emitter.c pump machinery) and pushes its deferred
``stateChanged`` emissions into it, so both engines share one pump
and one FIFO.
"""

import asyncio
import os

from . import utils as mod_utils
from .events import _native

__all__ = ['defer', 'pump_enabled', 'set_pump_enabled', 'pump_depth',
           'wheel_arm', 'wheel_arm_many', 'wheel_cancel', 'wheel_depth',
           'WHEEL_QUANTUM_MS']

# Bound to the profile module while its sampler runs, so SIGPROF
# samples landing mid-pump attribute to the runq_pump phase (the
# native engine's pump marks the phase in C; this seam covers the
# pure fallback).
_prof = None


if _native is not None:
    defer = _native.pump_defer
    _set_pump_enabled = _native.pump_set_enabled
    _pump_enabled = _native.pump_enabled

    def set_pump_enabled(flag):
        """Enable/disable pump coalescing; returns the previous
        setting (for try/finally restoration in benches and tests)."""
        return _set_pump_enabled(bool(flag))

    def pump_enabled():
        return _pump_enabled()

    pump_depth = _native.pump_depth
else:
    _pending = {}  # loop -> list of (cb, *args) entry tuples
    _enabled = True

    def _pump(loop):
        entries = _pending.pop(loop, None)
        if entries is None:
            return
        prof = _prof
        tok = prof.push_phase('runq_pump') if prof is not None else None
        try:
            for entry in entries:
                try:
                    entry[0](*entry[1:])
                except (SystemExit, KeyboardInterrupt):
                    raise
                except BaseException as exc:
                    loop.call_exception_handler({
                        'message': 'cueball runq deferral',
                        'exception': exc,
                    })
        finally:
            if prof is not None:
                prof.pop_phase(tok)

    def defer(cb, *args):
        """Schedule ``cb(*args)`` for the next loop iteration on the
        shared engine pump (plain ``call_soon`` when the pump is
        disabled). Requires a running event loop, like call_soon."""
        loop = asyncio.get_running_loop()
        if not _enabled:
            loop.call_soon(cb, *args)
            return
        batch = _pending.get(loop)
        if batch is not None:
            # Pump already scheduled for this loop's current tick.
            batch.append((cb,) + args)
            return
        if _pending:
            # Batches stranded on loops that closed before draining
            # died with their loop (like undelivered call_soon
            # handles); prune so they can't accumulate across
            # asyncio.run() calls.
            for stale in [ln for ln in _pending if ln.is_closed()]:
                del _pending[stale]
        _pending[loop] = [(cb,) + args]
        loop.call_soon(_pump, loop)

    def set_pump_enabled(flag):
        """Enable/disable pump coalescing; returns the previous
        setting (for try/finally restoration in benches and tests)."""
        global _enabled
        old = _enabled
        _enabled = bool(flag)
        return old

    def pump_enabled():
        return _enabled

    def pump_depth():
        """Entries waiting in undrained pump batches (all loops) —
        exported as the cueball_pump_queue_depth gauge."""
        return sum(len(batch) for batch in _pending.values())


if os.environ.get('CUEBALL_NO_PUMP'):
    set_pump_enabled(False)


# -- batched claim-deadline timer wheel ----------------------------------
#
# Arming a per-claim asyncio timer costs a heapq push + Handle +
# TimerHandle and, far worse, a heap pollution of cancelled entries for
# every claim that completes in time (nearly all of them — round-6
# profile, docs/claim-path-profile.md). The wheel coalesces claim
# deadlines into WHEEL_QUANTUM_MS buckets with ONE loop.call_later per
# bucket: arming and cancelling are plain dict ops, and a bucket's
# single timer fires every handle that is still parked in it. Claim
# timeouts are second-resolution liveness bounds, so up to one quantum
# of firing slop is well inside spec (the FSM re-checks the real
# deadline against current_millis() when it fires).

WHEEL_QUANTUM_MS = 5.0

_wheel: dict = {}  # loop -> {bucket: {token: handle}}
_wheel_tok = 0

#: Optional native bucket-timer hook: ``fn(loop, delay_ms, fire) ->
#: bool`` arms the bucket deadline on the C transport plane's deadline
#: heap (one TIMER completion in the batched drain instead of an
#: asyncio TimerHandle per bucket). A False return — no plane bound to
#: this loop, or it is shutting down — falls back to loop.call_later,
#: so netsim/virtual-clock loops and plain asyncio pools are
#: untouched. Installed by a native transport on import; this package
#: has none yet, so it stays None.
_native_timer = None


def set_native_timer(fn) -> None:
    """Install (or clear, with None) the native bucket-timer hook."""
    global _native_timer
    _native_timer = fn


def _arm_bucket(loop, bucket) -> None:
    """Arm the single shared timer for a fresh wheel bucket, on the
    native plane's deadline heap when one is bound to this loop, else
    via loop.call_later."""
    delay_ms = max(
        bucket * WHEEL_QUANTUM_MS - mod_utils.current_millis(), 0.0)
    hook = _native_timer
    if hook is not None:
        def fire(loop=loop, bucket=bucket):
            _wheel_fire(loop, bucket)
        if hook(loop, delay_ms, fire):
            return
    loop.call_later(delay_ms / 1000.0, _wheel_fire, loop, bucket)


def wheel_arm(deadline_ms, handle):
    """Park `handle` until monotonic-ms `deadline_ms` rounds up to its
    wheel bucket; returns an opaque token for wheel_cancel(). When the
    bucket fires, `handle._ch_wheel_fire(token)` decides whether the
    deadline still applies. Requires a running loop, like call_soon."""
    global _wheel_tok
    loop = asyncio.get_running_loop()
    bucket = int(deadline_ms // WHEEL_QUANTUM_MS) + 1
    buckets = _wheel.get(loop)
    if buckets is None:
        if _wheel:
            # Prune buckets stranded on closed loops (their timers
            # died with the loop), mirroring the pump's pruning.
            for stale in [ln for ln in _wheel if ln.is_closed()]:
                del _wheel[stale]
        buckets = _wheel[loop] = {}
    _wheel_tok += 1
    token = (loop, bucket, _wheel_tok)
    slot = buckets.get(bucket)
    if slot is None:
        slot = buckets[bucket] = {}
        _arm_bucket(loop, bucket)
    slot[token] = handle
    return token


def wheel_arm_many(deadline_ms, handles):
    """Batched wheel_arm for handles sharing one deadline (the
    claim_many park path): the loop lookup, bucket computation and
    timer-exists check are paid once for the whole batch, then each
    handle is one dict insert. Returns one token per handle, in
    order."""
    global _wheel_tok
    loop = asyncio.get_running_loop()
    bucket = int(deadline_ms // WHEEL_QUANTUM_MS) + 1
    buckets = _wheel.get(loop)
    if buckets is None:
        if _wheel:
            for stale in [ln for ln in _wheel if ln.is_closed()]:
                del _wheel[stale]
        buckets = _wheel[loop] = {}
    slot = buckets.get(bucket)
    if slot is None:
        slot = buckets[bucket] = {}
        _arm_bucket(loop, bucket)
    tokens = []
    for handle in handles:
        _wheel_tok += 1
        token = (loop, bucket, _wheel_tok)
        slot[token] = handle
        tokens.append(token)
    return tokens


def _wheel_fire(loop, bucket):
    buckets = _wheel.get(loop)
    if buckets is None:
        return
    slot = buckets.pop(bucket, None)
    if not buckets:
        _wheel.pop(loop, None)
    if not slot:
        return
    for token, handle in slot.items():
        try:
            handle._ch_wheel_fire(token)
        except (SystemExit, KeyboardInterrupt):
            raise
        except BaseException as exc:
            loop.call_exception_handler({
                'message': 'cueball timer wheel deadline',
                'exception': exc,
            })


def wheel_cancel(token):
    """Unpark a handle; cancelling is two dict lookups and a pop — the
    bucket's shared timer is left to fire and find nobody home."""
    buckets = _wheel.get(token[0])
    if buckets is None:
        return
    slot = buckets.get(token[1])
    if slot is not None:
        slot.pop(token, None)


def wheel_depth():
    """Handles currently parked in the wheel (all loops/buckets)."""
    return sum(len(slot)
               for buckets in _wheel.values()
               for slot in buckets.values())
