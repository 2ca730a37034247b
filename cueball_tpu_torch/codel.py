"""Controlled-Delay (CoDel) overload shedding for the claim queue.

Rebuild of reference `lib/codel.js` (which adapts the ACM CoDel reference
pseudocode, https://queue.acm.org/appendices/codel.html, to claim-queue
sojourn times). The pool feeds each waiter's enqueue time to
``overloaded()`` at dequeue; while the queue's minimum sojourn stays above
the target for a full control interval, claims are dropped at a rate whose
interval shrinks proportionally to 1/sqrt(count), steering the queue delay
toward the target. ``get_max_idle()`` supplies the claim timeout: 10x the
target in a healthy system, 3x when persistently overloaded
(reference lib/codel.js:100-118).
"""

from __future__ import annotations

import math

from .utils import current_millis

CODEL_INTERVAL = 100  # ms control interval (reference lib/codel.js:16)

# Bounds on any EXTERNALLY-set target (the fleet control plane's
# actuation path, parallel.control). The reference never mutates the
# target after construction; set_target exists solely for that batched
# path, and the guard keeps a wild decision column from ever driving
# the target to 0 (drop everything) or unbounded (shed nothing).
CODEL_TARGET_MIN = 1.0
CODEL_TARGET_MAX = 60_000.0

# Pacer cadence (ms) for the pool's continuous-evaluation shave-mode law.
# Classic CoDel evaluates its control law at every dequeue of a busy
# queue; a connection pool dequeues only when a connection is released,
# so with long checkout holds the drop decisions quantize onto the
# release cadence (plus the 100 ms re-arm interval) and the achieved
# claim sojourn sits well above targetClaimDelay. While the service
# process is demonstrably live, the pool runs a shave-mode law between
# dequeues at this cadence: CoDel's entry condition (head above target
# for a full control interval), then shed every above-target waiter per
# tick, with hysteretic exit. ControlledDelay itself is untouched and
# still consulted at dequeue sites. See docs/internals.md (CoDel
# section) and Pool._arm_codel_pacer.
CODEL_PACE = 10


class ControlledDelay:
    def __init__(self, target_claim_delay: float):
        if not isinstance(target_claim_delay, (int, float)) or \
                isinstance(target_claim_delay, bool) or \
                not math.isfinite(target_claim_delay):
            raise AssertionError('targetClaimDelay must be a finite number')
        self.cd_targdelay = target_claim_delay
        self.cd_first_above_time = 0.0
        self.cd_drop_next = 0.0
        self.cd_count = 0
        self.cd_dropping = False
        self.cd_last_empty: float | None = None
        # Last overloaded() decision detail, for claim-trace 'codel'
        # event spans: (sojourn_ms, dropping_mode, drop_count).
        self.cd_last_sojourn = 0.0
        self.cd_last_decision: bool | None = None

    def set_target(self, target_ms: float) -> None:
        """Guarded external target set (control-plane actuation only).

        Raises ValueError out of range; on success only the target
        moves — the drop-law state (first_above/drop_next/count) is
        carried, so a tightened target takes effect through the normal
        interval machinery instead of causing a drop burst."""
        if not isinstance(target_ms, (int, float)) or \
                isinstance(target_ms, bool) or \
                not math.isfinite(target_ms) or \
                not CODEL_TARGET_MIN <= target_ms <= CODEL_TARGET_MAX:
            raise ValueError(
                'codel target must be in [%g, %g] ms, got %r'
                % (CODEL_TARGET_MIN, CODEL_TARGET_MAX, target_ms))
        self.cd_targdelay = float(target_ms)

    setTarget = set_target

    def can_drop(self, now: float, start: float) -> bool:
        sojourn = now - start
        if sojourn < self.cd_targdelay:
            self.cd_first_above_time = 0.0
        elif self.cd_first_above_time == 0.0:
            self.cd_first_above_time = now + CODEL_INTERVAL
        elif now >= self.cd_first_above_time:
            return True
        return False

    def get_drop_next(self, now: float) -> float:
        return now + CODEL_INTERVAL / math.sqrt(self.cd_count)

    def overloaded(self, start: float) -> bool:
        """Given a claim's enqueue time, decide drop-on-dequeue
        (reference lib/codel.js:52-86)."""
        now = current_millis()
        self.cd_last_sojourn = now - start
        ok_to_drop = self.can_drop(now, start)
        drop_claim = False

        if self.cd_dropping:
            if not ok_to_drop:
                self.cd_dropping = False
            elif now >= self.cd_drop_next:
                drop_claim = True
                self.cd_count += 1
        elif ok_to_drop and (
                (now - self.cd_drop_next < CODEL_INTERVAL) or
                (now - self.cd_first_above_time >= CODEL_INTERVAL)):
            drop_claim = True
            self.cd_dropping = True
            if now - self.cd_drop_next < CODEL_INTERVAL:
                self.cd_count = self.cd_count - 2 if self.cd_count > 2 else 1
            else:
                self.cd_count = 1
            self.cd_drop_next = self.get_drop_next(now)

        self.cd_last_decision = drop_claim
        return drop_claim

    def empty(self) -> None:
        """The wait queue fully drained (reference lib/codel.js:88-94)."""
        self.cd_last_empty = current_millis()
        self.cd_first_above_time = 0.0

    def get_max_idle(self) -> float:
        """Max queue-sit time before a waiter is timed out: 10x target
        normally, 3x under persistent overload (reference
        lib/codel.js:96-118)."""
        bound = self.cd_targdelay * 10
        now = current_millis()
        if self.cd_last_empty is not None and \
                self.cd_last_empty < (now - bound):
            return self.cd_targdelay * 3
        return bound

    getMaxIdle = get_max_idle
