"""Virtual time: the clock and event loop under every netsim run.

A scenario must be (a) fast — a million-op soak in seconds — and
(b) deterministic — the same seed walks the same schedule. Both fall
out of the same move: no netsim run ever sleeps on a wall clock.
``VirtualClock`` is a number that only moves when the loop has nothing
runnable, and ``VirtualLoop`` is a stock asyncio selector loop whose
``time()`` reads that number and whose selector, instead of blocking
in ``select()``, polls real fds with a zero timeout and then jumps the
clock straight to the next timer deadline. Every ``call_later``,
``asyncio.sleep``, ``wait_for`` and FSM ``S.timeout`` in the framework
then runs at full CPU speed in strict deadline order.

The loop shim pairs with the process-wide clock seam in
the package's ``utils``: ``run()`` installs the same VirtualClock behind
``utils.current_millis()`` / ``utils.wall_time()`` (CoDel, traces,
TTL arithmetic) and a seeded ``random.Random`` behind
``utils.get_rng()``, so one seed pins the whole run. See
docs/netsim.md.
"""

from __future__ import annotations

import asyncio
import random
import selectors

from .. import utils as mod_utils

# Fixed wall-clock origin for virtual runs: TTL deadlines and trace
# timestamps are reproducible run to run (2023-11-14T22:13:20Z).
VIRTUAL_EPOCH = 1_700_000_000.0


class VirtualClock:
    """A clock that moves only when advanced. Satisfies the
    utils.set_clock interface (monotonic()/wall(), seconds)."""

    def __init__(self, start: float = 0.0,
                 epoch: float = VIRTUAL_EPOCH):
        self._mono = start
        self._epoch = epoch

    def monotonic(self) -> float:
        return self._mono

    def wall(self) -> float:
        return self._epoch + self._mono

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError('cannot advance a clock backwards')
        self._mono += dt


class LoopStarvedError(RuntimeError):
    """The virtual loop has no ready callback, no timer, and no
    network to wait on: real asyncio would block forever. Raised
    instead so a deadlocked scenario fails fast with a diagnosis
    rather than hanging the suite."""


class _VirtualSelector:
    """Selector shim: poll real fds without blocking, then account the
    wait the loop asked for by advancing the virtual clock instead of
    sleeping through it."""

    def __init__(self, inner: selectors.BaseSelector,
                 clock: VirtualClock):
        self._inner = inner
        self._clock = clock

    def select(self, timeout=None):
        ready = self._inner.select(0)
        if ready:
            return ready
        if timeout is None:
            raise LoopStarvedError(
                'virtual loop starved: no ready callbacks and no '
                'timers pending — a scenario coroutine is awaiting '
                'something nothing will ever deliver')
        if timeout > 0:
            self._clock.advance(timeout)
        return []

    def __getattr__(self, name):
        return getattr(self._inner, name)


class VirtualLoop(asyncio.SelectorEventLoop):
    """Asyncio loop on virtual time. Drop-in: everything scheduled via
    ``loop.call_later``/``loop.time`` — FSM timers, CoDel pacers, DNS
    deadlines — sees the virtual clock and fires in deadline order at
    CPU speed."""

    def __init__(self, clock: VirtualClock | None = None):
        self.vclock = clock if clock is not None else VirtualClock()
        inner = selectors.DefaultSelector()
        super().__init__(_VirtualSelector(inner, self.vclock))

    def time(self) -> float:
        return self.vclock.monotonic()


def run(coro, seed: int = 0, clock: VirtualClock | None = None):
    """Run ``coro`` to completion on a fresh VirtualLoop with the
    process-wide clock and RNG seams pointed at virtual time and a
    ``random.Random(seed)``; restores both on exit. The netsim
    equivalent of ``asyncio.run()`` — one call makes a run fully
    deterministic in its ``seed``."""
    clock = clock if clock is not None else VirtualClock()
    loop = VirtualLoop(clock)
    old_clock = mod_utils.set_clock(clock)
    old_rng = mod_utils.set_rng(random.Random(seed))
    try:
        asyncio.set_event_loop(loop)
        return loop.run_until_complete(coro)
    finally:
        asyncio.set_event_loop(None)
        try:
            loop.close()
        finally:
            mod_utils.set_clock(old_clock)
            mod_utils.set_rng(old_rng)
