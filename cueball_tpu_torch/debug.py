"""The port's part of the SIGUSR2 dump and of a failure dump: the
counterpart of the ``-- fleet health --`` section of
``cueball_tpu.debug`` (``_health_section``) and of the ``health`` record
``cueball_tpu.netsim.scenario`` embeds, over the port's own samplers
and health monitors.

- :func:`health_section` prints, line for line, what the JAX package
  prints for its monitors, so an operator's grep for ``gray`` finds the
  same lines in either dump.
- :func:`dump_fleet_runtime` adds one line per live port sampler
  before that section.
- :func:`install_debug_handler` binds a signal (SIGUSR2) to that dump
  and chains to the handler it replaces, so one signal gives both the
  JAX package's FSM dump and the port's section, whichever handler was
  installed last.
- :func:`health_record` is the failure dump's ``health`` entry.
"""

from __future__ import annotations

import asyncio
import io
import logging
import os
import signal

from .parallel.health import active_monitors, reduce_health
from .parallel.sampler import active_samplers

_LOG = logging.getLogger('cueball.debug')


def health_section() -> str:
    """'-- fleet health --' dump lines for every active port
    HealthMonitor; '' when there is none."""
    monitors = active_monitors()
    if not monitors:
        return ''
    out = ['-- fleet health (%d monitor(s)) --' % len(monitors)]
    for mon in monitors:
        last = mon.hm_last
        if last is None:
            out.append('  (no tick yet)')
            continue
        f = last['fleet']
        out.append(
            '  epoch=%d backends=%d gray=%s burn_fast=%.2f '
            'burn_slow=%.2f p99=%.1fms err_rate=%.4f%s%s' % (
                last['epoch'], int(f['n_backends']),
                ','.join(last['gray']) or '-',
                float(f['burn_fast']), float(f['burn_slow']),
                float(f['claim_p99_ms']), float(f['err_rate']),
                ' PAGE' if f['alert_page'] else '',
                ' TICKET' if f['alert_ticket'] else ''))
        for key, b in sorted(last['backends'].items()):
            if not b['gray']:
                continue
            out.append('   gray %-24s ewma=%.1fms z=%.1f score=%d' % (
                key, b['ewma_ms'], b['z'], b['score']))
    return '\n'.join(out) + '\n'


def dump_fleet_runtime(stream=None) -> str:
    """The port's dump: one line per live FleetSampler (device, pools,
    shard, ticks), then :func:`health_section`. Returns the report;
    also writes it to ``stream`` when given."""
    buf = io.StringIO()
    buf.write('cueball_tpu_torch fleet runtime pid=%d\n' % os.getpid())
    for s in active_samplers():
        where = ('mesh %s' % dict(s.fs_mesh.shape) if s.fs_mesh is not None
                 else str(s.fs_device))
        buf.write('  fleet_sampler device=%s pools=%d shard=%s ticks=%d\n'
                  % (where, len(s.fs_rows),
                     '-' if s.fs_shard is None else s.fs_shard,
                     s.fs_ticks))
    buf.write(health_section())
    report = buf.getvalue()
    if stream is not None:
        stream.write(report)
    return report


def _emit_dump(signum: int) -> None:
    _LOG.warning('debug signal %d: port fleet runtime\n%s', signum,
                 dump_fleet_runtime())


def install_debug_handler(signum: int = signal.SIGUSR2):
    """Bind ``signum`` to the port's dump and return the handler it
    replaces, which the new one calls after its own work when it is
    callable. The dump goes to the ``cueball.debug`` logger. Writing it
    is not safe at any interrupt point, so when an asyncio loop runs on
    the signalled thread the write is deferred to it with
    ``call_soon_threadsafe``, and made inline only when none runs.
    Signals reach the main thread only: install from there."""
    prev = signal.getsignal(signum)

    def on_signal(sig, frame):
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        if loop is not None:
            loop.call_soon_threadsafe(_emit_dump, sig)
        else:
            _emit_dump(sig)
        if callable(prev):
            prev(sig, frame)

    signal.signal(signum, on_signal)
    return prev


def uninstall_debug_handler(prev, signum: int = signal.SIGUSR2) -> None:
    """Put back the handler :func:`install_debug_handler` returned."""
    signal.signal(signum, prev)


def health_record() -> dict | None:
    """The failure dump's ``health`` entry: the merged last verdicts of
    every active port monitor and each monitor's verdict history; None
    when no monitor runs."""
    monitors = active_monitors()
    if not monitors:
        return None
    return {
        'fleet': reduce_health([m.hm_last for m in monitors]),
        'history': [list(m.hm_history) for m in monitors],
    }
