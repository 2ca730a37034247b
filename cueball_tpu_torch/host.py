"""The process-wide host state the fleet sampler and the health monitor
reach: the port's own copy of the seams the JAX package keeps in
``cueball_tpu.utils`` (the clock), ``cueball_tpu.pool`` (the recurring
timer), ``cueball_tpu.trace`` (the backend registry, the attribution
sinks and the active metrics collector) and ``cueball_tpu.wiretap``
(the loop-lag sampler).

``FleetSampler`` and ``HealthMonitor`` take ``options['host']``: any
object with the names below. This module is the default. A program
that runs the JAX package's tracer beside the port passes
:func:`seam_over` of those modules instead, so both packages read one
clock, one backend registry and one trace surface. The seam adds no
behaviour.

The loop-lag sampler (``start_loop_lag_sampler`` and the functions
after it) is a copy of ``cueball_tpu.wiretap``'s: one sampler per
event loop, and ``loop_lag_p99_us()`` reads the running loop's.
"""

from __future__ import annotations

import asyncio
import threading
import time
import types

def current_millis() -> float:
    """Monotonic time in milliseconds. The port has no virtual clock of
    its own: a program on the JAX package's clock passes
    :func:`seam_over`, whose clock and loop lag are that package's."""
    return time.monotonic() * 1000.0


_SYSTEM_MILLIS = current_millis


class _Interval:
    """Recurring timer emitting 'timeout' on an EventEmitter every
    ``ms`` milliseconds on the running asyncio loop."""

    def __init__(self, ms: float, emitter):
        self._ms = ms
        self._emitter = emitter
        self._cancelled = False
        self._handle = None
        self._schedule()

    def _schedule(self):
        loop = asyncio.get_running_loop()
        self._handle = loop.call_later(self._ms / 1000.0, self._fire)

    def _fire(self):
        if self._cancelled:
            return
        self._emitter.emit('timeout')
        if not self._cancelled:
            self._schedule()

    def cancel(self):
        self._cancelled = True
        if self._handle is not None:
            self._handle.cancel()


# -- backend identity -------------------------------------------------------
# Stable small integers for backend keys: the health engine's
# BackendTable uses a backend's index as its row. Index 0 is RESERVED
# for the unattributed bucket (key ''): claims that never reached a
# backend.

_BACKEND_LOCK = threading.Lock()
_BACKEND_KEYS: list = ['']
_BACKEND_IDS: dict = {'': 0}
#: Indexes past this fall back to row 0, as in the JAX package, whose
#: native recorder stamps the index into 12 flag bits.
BACKEND_INDEX_MAX = 0xFFE


def backend_index(key) -> int:
    """The stable row index for a backend key (registering it on first
    sight); 0 (unattributed) once the registry is full."""
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


# Attribution sinks (the health engine's BackendTable): whoever records
# finished claims offers each one to every sink with its backend key,
# ``sink.observe(key, service_ms, claim_ms, ok)``, and each CoDel shed
# as ``sink.observe_shed(key)``. Copy-on-write tuple, rebound under a
# lock: the monitors of several shard loops join at once.
_BACKEND_SINKS: tuple = ()
_SINKS_LOCK = threading.Lock()


def add_backend_sink(sink) -> None:
    global _BACKEND_SINKS
    with _SINKS_LOCK:
        _BACKEND_SINKS = _BACKEND_SINKS + (sink,)


def remove_backend_sink(sink) -> None:
    global _BACKEND_SINKS
    with _SINKS_LOCK:
        _BACKEND_SINKS = tuple(s for s in _BACKEND_SINKS if s is not sink)


def backend_sinks() -> tuple:
    """The registered attribution sinks, for a caller that records
    claims."""
    return _BACKEND_SINKS


def active_collector():
    """The metrics collector of an enabled claim tracer. The port has no
    tracer, so there is none: publishers use the collector they were
    given."""
    return None


def drain_native() -> None:
    """Replay claims a native recorder holds into the attribution sinks
    before a health tick. The port has no native recorder."""


# -- loop-lag sampler -------------------------------------------------------
# How late each event loop runs a timer callback: a recurring call_later
# whose scheduled instant is compared with the loop's clock when it
# fires. The FleetSampler's loop_lag_p99_us column reads it.

DEFAULT_LAG_INTERVAL_MS = 20.0
DEFAULT_LAG_RING = 512


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
    (idempotent per loop). Refuses, recording why in
    loop_lag_stats()['disabled_reason'], under a non-system clock (a
    program that replaced :func:`current_millis`, as a test that
    freezes time does; a timer firing "late" in virtual time is
    meaningless) or when no loop is running here (as on a thread
    without one)."""
    global _lag_disabled_reason
    if current_millis is not _SYSTEM_MILLIS:
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
    samplers = list(_lag_samplers.values())
    if len(samplers) == 1:
        return samplers[0]
    return None


def loop_lag_stats() -> dict:
    """Lag stats for the current loop's sampler when there is one,
    else the worst-case merge across all sampled loops."""
    sampler = _current_sampler()
    samplers = list(_lag_samplers.values())
    if sampler is not None:
        out = sampler.stats()
    elif samplers:
        merged = [s.stats() for s in samplers]
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
    """The FleetSampler's loop-lag column: the current loop's lag p99
    in us (0.0 when no sampler is armed here), read once per O(dirty)
    patch pass, not per row."""
    sampler = _current_sampler()
    if sampler is None:
        return 0.0
    ordered = sorted(sampler.samples)
    n = len(ordered)
    if n == 0:
        return 0.0
    return ordered[min(n - 1, int(0.99 * n))]


# -- the seam over another package's host state -----------------------------

def seam_over(utils, pool, trace, wiretap):
    """A host seam over the JAX package's host state, for a port
    sampler or monitor that runs beside that package's pools and claim
    tracer: ``utils`` gives the clock (read late, so a clock installed
    later applies), ``pool`` the recurring ``_Interval``, ``trace`` the
    backend registry, the attribution sinks and the active collector,
    ``wiretap`` the loop-lag p99. The caller passes the four modules
    (``cueball_tpu.utils``, ``.pool``, ``.trace``, ``.wiretap``); this
    function imports none of them.

    ``trace`` has no public name for two of the seam's needs, so they
    reach its private ones: ``backend_sinks`` reads
    ``trace._BACKEND_SINKS``, and ``drain_native`` calls
    ``trace._runtime._drain_native()``, as that package's own
    HealthMonitor does. Sinks join and leave under a lock of the seam,
    since the monitors of several shard loops join at once."""
    lock = threading.Lock()

    def add_backend_sink(sink):
        with lock:
            trace.add_backend_sink(sink)

    def remove_backend_sink(sink):
        with lock:
            trace.remove_backend_sink(sink)

    def drain_native():
        runtime = trace._runtime
        if runtime is not None:
            runtime._drain_native()

    return types.SimpleNamespace(
        current_millis=lambda: utils.current_millis(),
        _Interval=pool._Interval,
        backend_index=trace.backend_index,
        backend_key_for=trace.backend_key_for,
        add_backend_sink=add_backend_sink,
        remove_backend_sink=remove_backend_sink,
        backend_sinks=lambda: trace._BACKEND_SINKS,
        active_collector=trace.active_collector,
        loop_lag_p99_us=wiretap.loop_lag_p99_us,
        drain_native=drain_native)
