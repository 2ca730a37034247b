"""The process-wide host state the fleet sampler and the health monitor
reach: the clock (``utils``), the recurring timer (``pool``), the
backend registry, the attribution sinks and the active metrics
collector (``trace``) and the loop-lag sampler (``wiretap``), all of
this package's own pool layer.

``FleetSampler`` and ``HealthMonitor`` take ``options['host']``: any
object with the names below. This module is the default:
:func:`seam_over` of this package's ``utils``, ``pool``, ``trace`` and
``wiretap``, so the port's pools and its sampler read one clock, one
backend registry and one trace surface. A program that runs the JAX
package's pools and tracer beside the port passes :func:`seam_over` of
that package's modules instead. The seam adds no behaviour.

The loop-lag sampler's functions are ``wiretap``'s, re-exported.
"""

from __future__ import annotations

import threading
import types

from . import pool, trace, utils, wiretap
from .wiretap import (DEFAULT_LAG_INTERVAL_MS, DEFAULT_LAG_RING,
                      _lag_samplers, loop_lag_p99_us, loop_lag_stats,
                      start_loop_lag_sampler, stop_loop_lag_sampler)

__all__ = [
    'seam_over', 'current_millis', 'backend_index', 'backend_key_for',
    'add_backend_sink', 'remove_backend_sink', 'backend_sinks',
    'active_collector', 'drain_native',
    'DEFAULT_LAG_INTERVAL_MS', 'DEFAULT_LAG_RING', 'loop_lag_p99_us',
    'loop_lag_stats', 'start_loop_lag_sampler', 'stop_loop_lag_sampler',
]


# -- the seam -----------------------------------------------------------------

def seam_over(utils, pool, trace, wiretap):
    """A host seam over one package's host state: ``utils`` gives the
    clock (read late, so a clock installed later applies), ``pool`` the
    recurring ``_Interval``, ``trace`` the backend registry, the
    attribution sinks and the active collector, ``wiretap`` the
    loop-lag p99. This module's own names are the seam over this
    package's modules; a program that runs the JAX package's pools and
    tracer beside the port passes ``cueball_tpu.utils``, ``.pool``,
    ``.trace`` and ``.wiretap`` instead (this function imports none of
    them).

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


_SEAM = seam_over(utils, pool, trace, wiretap)
current_millis = _SEAM.current_millis
_Interval = _SEAM._Interval
backend_index = _SEAM.backend_index
backend_key_for = _SEAM.backend_key_for
add_backend_sink = _SEAM.add_backend_sink
remove_backend_sink = _SEAM.remove_backend_sink
backend_sinks = _SEAM.backend_sinks
active_collector = _SEAM.active_collector
drain_native = _SEAM.drain_native
