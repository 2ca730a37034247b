"""The process-wide host state the fleet sampler and the health monitor
reach: the port's own copy of the seams the JAX package keeps in
``cueball_tpu.utils`` (the clock), ``cueball_tpu.pool`` (the recurring
timer), ``cueball_tpu.trace`` (the backend registry, the attribution
sinks and the active metrics collector) and ``cueball_tpu.wiretap``
(the loop-lag sampler).

``FleetSampler`` and ``HealthMonitor`` take ``options['host']``: any
object with the names below. This module is the default. A program
that runs the JAX package's tracer beside the port passes an object
built from those modules instead, so both packages read one clock, one
backend registry and one trace surface. The seam adds no behaviour.
"""

from __future__ import annotations

import asyncio
import threading
import time


def current_millis() -> float:
    """Monotonic time in milliseconds."""
    return time.monotonic() * 1000.0


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
# as ``sink.observe_shed(key)``. Copy-on-write tuple.
_BACKEND_SINKS: tuple = ()


def add_backend_sink(sink) -> None:
    global _BACKEND_SINKS
    _BACKEND_SINKS = _BACKEND_SINKS + (sink,)


def remove_backend_sink(sink) -> None:
    global _BACKEND_SINKS
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


def loop_lag_p99_us() -> float:
    """Event-loop callback lag p99 (us) of the current loop. The port
    arms no loop-lag sampler, so it reads 0.0, as the JAX package does
    while its sampler is unarmed."""
    return 0.0


def drain_native() -> None:
    """Replay claims a native recorder holds into the attribution sinks
    before a health tick. The port has no native recorder."""
