"""Runtime observability attach: flip diagnostics on a LIVE process;
this package's copy of the JAX package's ``debug``, with the port's
fleet runtime in the dump.

The reference enables claim stack-trace capture on a running process
with zero code change by attaching a dtrace probe (reference
lib/utils.js:59-99: the `capture-stack` USDT probe flips
`stackTracesEnabled` from outside). Python has no USDT, so the
equivalent external attach points are:

- **a signal** — :func:`install_debug_handler` binds SIGUSR2 (by
  default); each delivery toggles process-wide stack capture
  (utils.enable_stack_traces), arms or disarms the claim-path sampler
  and the loop-lag sampler, and dumps the FSM state + history ring of
  every pool, set, resolver and connection slot registered with the
  process-global pool monitor, every started shard router, the port's
  fleet samplers and health verdicts, the slowest claims and the
  profiler and wire-ledger sections to the ``cueball.debug`` logger,
  so an operator can `kill -USR2 <pid>` a wedged process and read what
  every FSM did last. The handler it replaces is called after it, so
  another package's handler installed first still runs.
- **environment variables** — read once at `import cueball_tpu_torch`:
  ``CUEBALL_STACK_TRACES=1`` starts with capture enabled, and
  ``CUEBALL_DEBUG_SIGNAL=1`` (or a signal name like ``SIGUSR1``)
  installs the handler without any application code.

The dump itself is also callable in-process (:func:`dump_fsm_histories`)
and is what the kang surface uses for ad-hoc archaeology.
:func:`health_section`, :func:`dump_fleet_runtime` and
:func:`health_record` are the port's own fleet-runtime parts of it
(the last is the failure dump's ``health`` entry).
"""

from __future__ import annotations

import io
import logging
import os
import signal
import sys
import threading

from . import trace as mod_trace
from . import utils as mod_utils
from .parallel.health import active_monitors, reduce_health
from .parallel.sampler import active_samplers

_LOG = logging.getLogger('cueball.debug')

#: This package's name: the path component :func:`_package_rel` scopes
#: frames by.
_PACKAGE = __name__.rpartition('.')[0]

# The licensed cross-thread marshal sites, as package-relative paths.
# LoopAffinityChecker licenses this set at runtime (and records which
# sites were actually exercised, so a test can prove the registry is
# live, not aspirational). Everything here is a deliberate cross-loop
# boundary: the shard marshal layer (worker/proc/router), the
# signal-handler dump deferral below, and the loop-lag sampler's stop
# from another thread than its loop's.
A001_MARSHAL_MODULES = (
    'debug.py',
    'shard/proc.py',
    'shard/router.py',
    'shard/worker.py',
    'wiretap.py',
)


def _fsm_line(tag: str, fsm) -> str:
    try:
        state = fsm.get_state()
    except Exception:
        state = '?'
    hist = []
    timed = getattr(fsm, 'get_history_timed', None)
    get_history = getattr(fsm, 'get_history', None)
    if timed is not None:
        try:
            # Dwell annotations (reference changelog #119): how long
            # each recorded state actually lasted.
            entries = timed()
            for i, (name, at) in enumerate(entries):
                if i + 1 < len(entries):
                    name += '(%dms)' % round(entries[i + 1][1] - at)
                hist.append(name)
        except Exception:
            pass
    elif get_history is not None:
        try:
            hist = get_history()
        except Exception:
            pass
    return '  %-14s state=%-12s history=%s\n' % (tag, state,
                                                 '->'.join(hist))


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


def _sampler_lines() -> str:
    """One line per live port FleetSampler (device, pools, shard,
    ticks); '' when none runs."""
    out = []
    for s in active_samplers():
        where = ('mesh %s' % dict(s.fs_mesh.shape) if s.fs_mesh is not None
                 else str(s.fs_device))
        out.append('  fleet_sampler device=%s pools=%d shard=%s ticks=%d\n'
                   % (where, len(s.fs_rows),
                      '-' if s.fs_shard is None else s.fs_shard,
                      s.fs_ticks))
    return ''.join(out)


def dump_fleet_runtime(stream=None) -> str:
    """The port's dump: one line per live FleetSampler (device, pools,
    shard, ticks), then :func:`health_section`. Returns the report;
    also writes it to ``stream`` when given."""
    buf = io.StringIO()
    buf.write('%s fleet runtime pid=%d\n' % (_PACKAGE, os.getpid()))
    buf.write(_sampler_lines())
    buf.write(health_section())
    report = buf.getvalue()
    if stream is not None:
        stream.write(report)
    return report


def dump_fsm_histories(stream=None) -> str:
    """Dump state + history of every FSM registered with the pool
    monitor (pools, sets, DNS resolvers, and their connection slots and
    socket managers). Returns the report; also writes it to `stream`
    when given."""
    from .monitor import pool_monitor

    buf = io.StringIO()
    buf.write('cueball FSM dump pid=%d t=%.3f stack_traces=%s\n' % (
        os.getpid(), mod_utils.wall_time(),
        mod_utils.stack_traces_enabled()))
    run_meta = mod_trace.get_run_metadata()
    if run_meta:
        # Inside a netsim scenario: name the replayable run this dump
        # belongs to (seed + scenario identity).
        buf.write('netsim run: %s\n' % ' '.join(
            '%s=%s' % (k, run_meta[k]) for k in sorted(run_meta)
            if k != 'schedule'))

    for uuid, pool in list(pool_monitor.pm_pools.items()):
        shard = getattr(pool, 'p_shard', None)
        buf.write('pool %s domain=%s%s\n' % (
            uuid, pool.p_domain,
            '' if shard is None else ' shard=%d' % shard))
        buf.write(_fsm_line('(pool)', pool))
        for key, slots in list(pool.p_connections.items()):
            for slot in slots:
                buf.write(_fsm_line('slot %s' % key[:12], slot))
                smgr = getattr(slot, 'csf_smgr', None)
                if smgr is not None:
                    buf.write(_fsm_line(' smgr', smgr))
        if pool.p_dead:
            buf.write('  dead=%s\n' % sorted(pool.p_dead.keys()))

    for uuid, cset in list(pool_monitor.pm_sets.items()):
        buf.write('set %s domain=%s\n' % (uuid, cset.cs_domain))
        buf.write(_fsm_line('(set)', cset))
        for key, slot in list(cset.cs_fsm.items()):
            buf.write(_fsm_line('slot %s' % key[:12], slot))
            smgr = getattr(slot, 'csf_smgr', None)
            if smgr is not None:
                buf.write(_fsm_line(' smgr', smgr))

    for uuid, res in list(pool_monitor.pm_dns_res.items()):
        buf.write('dns_res %s domain=%s\n' % (uuid, res.r_domain))
        buf.write(_fsm_line('(resolver)', res))

    # Started FleetRouters (if the shard package is in play): shard FSM
    # states and the pool -> shard ownership map, so one SIGUSR2 answers
    # "which shard owns the wedged pool" too.
    for router in mod_trace._active_fleet_routers():
        buf.write('fleet_router backend=%s shards=%d\n' % (
            router.fr_backend, router.fr_nshards))
        for sid, fsm in sorted(router.fr_fsms.items()):
            buf.write(_fsm_line('shard %d' % sid, fsm))
        for name, rec in sorted(router.fr_pools.items()):
            buf.write('  pool %-24s -> shard %d\n' % (name, rec.shard_id))

    # The port's fleet samplers and its health monitors' verdicts next
    # to the FSM states, so one SIGUSR2 also answers "which backend is
    # gray" and "is the SLO burning".
    buf.write(_sampler_lines())
    buf.write(health_section())

    # When claim tracing is on, the slowest recent claims land next to
    # the FSM states: a wedged process's dump answers both "what state
    # is everything in" and "where did claim latency go".
    traces = mod_trace.dump_traces()
    if traces:
        buf.write(traces)

    # Claim-path profiler: sampler state, fleet cost attribution, and
    # the slowest claims' phase ledgers. '' (section absent, dump still
    # well-formed) when nothing was ever profiled.
    from . import profile as mod_profile
    prof = mod_profile.dump_profile()
    if prof:
        buf.write(prof)

    # Transport wire ledger: per-seam counters, socket_wait wire
    # totals and loop-lag stats. Same absent-but-well-formed contract.
    from . import wiretap as mod_wiretap
    wire = mod_wiretap.dump_wiretap()
    if wire:
        buf.write(wire)

    report = buf.getvalue()
    if stream is not None:
        stream.write(report)
    return report


def _emit_dump(signum: int) -> None:
    _LOG.warning('debug signal %d: stack traces now %s\n%s',
                 signum,
                 'ENABLED' if mod_utils.stack_traces_enabled()
                 else 'disabled',
                 dump_fsm_histories())


def _on_debug_signal(signum, frame) -> None:
    """SIGUSR2 handler: toggle stack capture, dump all FSM histories.

    The toggle itself is plain Python state (safe at any interrupt
    point); the dump + logging are NOT reentrancy-safe (a buffered
    stream write interrupted mid-write raises RuntimeError), so when an
    asyncio loop is running they are deferred to it via
    call_soon_threadsafe (the only call_soon variant documented safe
    from signal handlers) and only run inline as a last resort. Then
    the handler :func:`install_debug_handler` replaced runs, when it
    is callable."""
    if mod_utils.stack_traces_enabled():
        mod_utils.disable_stack_traces()
    else:
        mod_utils.enable_stack_traces()
    # The toggle doubles as the profiler attach point (tools/cbprofile
    # `make profile`): first USR2 arms the SIGPROF phase sampler,
    # second disarms it — the dump that follows each delivery shows
    # the sampler state and whatever it collected. start/stop are
    # no-ops-with-reasons (netsim clock, non-main thread), never
    # raises out of a signal handler.
    try:
        from . import profile as mod_profile
        from . import wiretap as mod_wiretap
        if mod_utils.stack_traces_enabled():
            mod_profile.start_sampler()
            mod_wiretap.start_loop_lag_sampler()
        else:
            mod_profile.stop_sampler()
            mod_wiretap.stop_loop_lag_sampler()
    except Exception:
        pass
    import asyncio
    try:
        loop = asyncio.get_running_loop()
    except RuntimeError:
        loop = None
    if loop is not None:
        loop.call_soon_threadsafe(_emit_dump, signum)
    else:
        _emit_dump(signum)
    prev = _CHAINED.get(signum)
    if callable(prev):
        prev(signum, frame)


# signum -> the handler install_debug_handler replaced (never this
# module's own, so a second install does not toggle twice).
_CHAINED: dict = {}


def install_debug_handler(signum: int = signal.SIGUSR2):
    """Install the live-attach diagnostic handler (dtrace-probe
    analogue). Returns the previous handler, which the new one calls
    after its own work when it is callable. Signals reach the main
    thread only: install from there."""
    prev = signal.signal(signum, _on_debug_signal)
    if prev is not _on_debug_signal:
        _CHAINED[signum] = prev
    return prev


def uninstall_debug_handler(prev, signum: int = signal.SIGUSR2) -> None:
    """Put back the handler :func:`install_debug_handler` returned."""
    signal.signal(signum, prev)
    _CHAINED.pop(signum, None)


def _package_rel(filename: str) -> str | None:
    """Path relative to the innermost directory of this package, or
    None for frames outside the package."""
    parts = filename.replace('\\', '/').split('/')
    if _PACKAGE not in parts:
        return None
    idx = len(parts) - 1 - parts[::-1].index(_PACKAGE)
    rel = parts[idx + 1:]
    return '/'.join(rel) or None


# Default entry points watched by LoopAffinityChecker.watch() when no
# explicit method list is given. Deliberately NOT "every public
# method": wrapping listener-registration methods would change bound-
# method identity and break EventEmitter.remove_listener.
_DEFAULT_WATCH = ('claim', 'claim_cb', 'claim_many', 'stop',
                  'defer', 'wheel_arm', 'wheel_cancel')


class LoopAffinityChecker:
    """Opt-in runtime loop-affinity checker (the JAX package's runtime
    twin of its cbflow rule A001).

    While installed (``with LoopAffinityChecker() as lc:`` or
    ``lc.install()`` / ``lc.uninstall()``):

    - raw ``loop.call_soon``/``call_later``/``call_at`` from a thread
      that is not the loop's running thread is recorded as an
      ``off_thread_schedule`` violation (the bug class
      call_soon_threadsafe exists to prevent);
    - every ``call_soon_threadsafe`` / ``run_coroutine_threadsafe``
      is attributed to the nearest frame of this package: licensed
      modules (:data:`A001_MARSHAL_MODULES`) land in
      :attr:`marshals_exercised`, any other package frame is an
      ``unlicensed_marshal`` violation;
    - every FSM transition in the process (via
      ``fsm.add_transition_tracer``) must stay on the thread that
      performed that FSM's first transition
      (``off_thread_transition``);
    - :meth:`watch` wraps declared entry points of pool / cset /
      runq / shard-router objects so a direct off-thread call is
      caught even when it never reaches the loop
      (``off_thread_call``).

    Violations accumulate as dicts in :attr:`violations`;
    ``raise_on_violation=True`` turns the first one into an
    AssertionError at the offending call site.
    """

    def __init__(self, raise_on_violation: bool = False):
        self.raise_on_violation = raise_on_violation
        self.violations: list[dict] = []
        self.marshals_exercised: set[str] = set()
        self._installed = False
        self._saved: dict = {}
        self._watched: list = []
        self._class_watch: dict = {}
        self._instances: dict = {}
        self._fsm_threads: dict = {}
        self._tls = threading.local()

    # -- recording --------------------------------------------------------

    def _record(self, kind: str, **info) -> None:
        info['kind'] = kind
        self.violations.append(info)
        if self.raise_on_violation:
            raise AssertionError('loop-affinity violation: %r' % info)

    def _site(self):
        """Nearest frame of this package in the current call, skipping
        this module's own wrappers: (relpath, lineno) or None."""
        f = sys._getframe(2)
        here = _package_rel(__file__)
        while f is not None:
            rel = _package_rel(f.f_code.co_filename)
            if rel is not None and not (rel == here and
                                        f.f_code.co_name.startswith(
                                            '_lc_')):
                return rel, f.f_lineno
            f = f.f_back
        return None

    # -- loop patching ----------------------------------------------------

    def install(self):
        import asyncio

        if self._installed:
            return self
        base = asyncio.base_events.BaseEventLoop
        self._saved = {
            'call_soon': base.call_soon,
            'call_later': base.call_later,
            'call_at': base.call_at,
            'call_soon_threadsafe': base.call_soon_threadsafe,
        }
        checker = self

        def _guarded(name, check):
            orig = checker._saved[name]

            def _lc_wrapper(loop, *args, **kwargs):
                if not getattr(checker._tls, 'busy', False):
                    checker._tls.busy = True
                    try:
                        check(loop)
                    finally:
                        checker._tls.busy = False
                return orig(loop, *args, **kwargs)
            _lc_wrapper.__name__ = '_lc_' + name
            return _lc_wrapper

        def _check_same_thread(loop):
            owner = getattr(loop, '_thread_id', None)
            if owner is not None and owner != threading.get_ident():
                site = checker._site()
                checker._record(
                    'off_thread_schedule',
                    site=site, loop=repr(loop),
                    thread=threading.get_ident(), owner=owner)

        def _check_marshal(loop):
            site = checker._site()
            if site is None:
                return       # non-package caller: not ours to police
            rel = site[0]
            if rel in A001_MARSHAL_MODULES:
                checker.marshals_exercised.add(rel)
            else:
                checker._record('unlicensed_marshal', site=site,
                                thread=threading.get_ident())

        base.call_soon = _guarded('call_soon', _check_same_thread)
        base.call_later = _guarded('call_later', _check_same_thread)
        base.call_at = _guarded('call_at', _check_same_thread)
        base.call_soon_threadsafe = _guarded('call_soon_threadsafe',
                                             _check_marshal)

        from . import fsm as mod_fsm
        self._tracer = self._on_transition
        mod_fsm.add_transition_tracer(self._tracer)
        self._installed = True
        return self

    def uninstall(self) -> None:
        import asyncio

        if not self._installed:
            return
        base = asyncio.base_events.BaseEventLoop
        for name, orig in self._saved.items():
            setattr(base, name, orig)
        self._saved = {}
        from . import fsm as mod_fsm
        mod_fsm.remove_transition_tracer(self._tracer)
        while self._watched:
            obj, name, orig, had = self._watched.pop()
            if had:
                setattr(obj, name, orig)
            else:
                try:
                    delattr(obj, name)
                except AttributeError:
                    pass
        for (cls, name), orig in self._class_watch.items():
            setattr(cls, name, orig)
        self._class_watch.clear()
        self._instances.clear()
        # _fsm_threads is deliberately NOT cleared: it is the record
        # of what the checker observed (a test may assert on it after
        # uninstall); its strong refs die with the
        # checker object itself.
        self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    # -- FSM transition affinity ------------------------------------------

    def _on_transition(self, fsm, old_state, new_state) -> None:
        # Keyed by id() with a strong ref alongside, so ids cannot be
        # recycled while the checker is installed.
        key = id(fsm)
        tid = threading.get_ident()
        rec = self._fsm_threads.get(key)
        if rec is None:
            self._fsm_threads[key] = (fsm, tid)
        elif rec[1] != tid:
            self._record('off_thread_transition',
                         fsm=type(fsm).__name__,
                         transition=(old_state, new_state),
                         thread=tid, owner=rec[1])

    # -- explicit object watching -----------------------------------------

    def watch(self, obj, methods=None, tag: str | None = None):
        """Wrap `obj`'s entry-point methods (default: the subset of
        ``_DEFAULT_WATCH`` it actually has) so every call is checked
        against the thread that made the FIRST call. Works on
        modules (runq) and plain instances via instance attributes;
        fully slotted instances (the FSM family: pool, cset, router
        — no ``__dict__``) get a class-level wrapper that dispatches
        on a per-instance registry, so unwatched siblings pay one
        dict miss and nothing else."""
        names = methods if methods is not None else [
            n for n in _DEFAULT_WATCH
            if callable(getattr(obj, n, None))]
        owner: dict = {'thread': None}
        label = tag or type(obj).__name__

        def _check(name):
            tid = threading.get_ident()
            if owner['thread'] is None:
                owner['thread'] = tid
            elif owner['thread'] != tid:
                self._record('off_thread_call', obj=label,
                             method=name, thread=tid,
                             owner=owner['thread'])

        if getattr(obj, '__dict__', None) is not None:
            def _make(name, orig):
                def _lc_watched(*args, **kwargs):
                    _check(name)
                    return orig(*args, **kwargs)
                _lc_watched.__name__ = '_lc_' + name
                return _lc_watched

            for name in names:
                orig = getattr(obj, name)
                had = name in vars(obj)
                setattr(obj, name, _make(name, orig))
                self._watched.append((obj, name, orig, had))
            return obj

        # Slotted instance: per-class wrapper, per-instance dispatch.
        cls = type(obj)
        self._instances[id(obj)] = (obj, set(names), _check)
        for name in names:
            key = (cls, name)
            if key in self._class_watch:
                continue
            orig = getattr(cls, name)
            self._class_watch[key] = orig

            def _make_cls(name, orig):
                def _lc_watched(inst, *args, **kwargs):
                    rec = self._instances.get(id(inst))
                    if rec is not None and name in rec[1]:
                        rec[2](name)
                    return orig(inst, *args, **kwargs)
                _lc_watched.__name__ = '_lc_' + name
                return _lc_watched

            setattr(cls, name, _make_cls(name, orig))
        return obj


def init_from_env(env=os.environ) -> None:
    """Apply CUEBALL_STACK_TRACES / CUEBALL_DEBUG_SIGNAL. Called once at
    package import so both work with zero application code. Bad values
    (unknown signal name, import off the main thread) must not make the
    package unimportable: they log and continue."""
    if env.get('CUEBALL_STACK_TRACES', '') not in ('', '0'):
        mod_utils.enable_stack_traces()
    sig = env.get('CUEBALL_DEBUG_SIGNAL', '')
    if sig and sig != '0':
        try:
            name = sig.upper()
            if not name.startswith('SIG'):
                name = 'SIG' + name
            signum = signal.SIGUSR2 if sig == '1' \
                else getattr(signal, name)
            install_debug_handler(signum)
        except (AttributeError, ValueError, OSError) as e:
            _LOG.warning(
                'CUEBALL_DEBUG_SIGNAL=%s not installed: %s', sig, e)


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
