"""Support algorithms and validation helpers.

Rebuild of reference `lib/utils.js`:
- recovery-spec validation (lib/utils.js:116-186)
- randomized retry delay spread (lib/utils.js:446-461)
- monotonic millisecond clock (lib/utils.js:198-204)
- Fisher-Yates shuffle (lib/utils.js:207-217)
- the pure `planRebalance` pool planner (lib/utils.js:239-393)
- claim/release stack-trace gating (lib/utils.js:48-115)
- error-event metric helpers (lib/utils.js:29-46,395-444)
"""

from __future__ import annotations

import logging
import math
import random
import time
import traceback

from . import metrics as mod_metrics


# ---------------------------------------------------------------------------
# Contextual child loggers (the bunyan log.child analogue)
#
# The reference binds component/backend/localPort context into every log
# record via bunyan child loggers (reference lib/pool.js:152-157,
# lib/connection-fsm.js:149-155,913-918). The stdlib analogue is a
# LoggerAdapter: context rides on the record (record.cueball, for
# structured handlers) and is prefixed into the message (for plain
# formatters). Children of children merge their context.

class ContextLogger(logging.LoggerAdapter):
    def process(self, msg, kwargs):
        extra = kwargs.get('extra')
        if extra is None:
            kwargs['extra'] = extra = {}
        extra.setdefault('cueball', self.extra)
        if self.extra:
            ctx = ' '.join(
                '%s=%s' % (k, v) for k, v in self.extra.items())
            msg = '[%s] %s' % (ctx, msg)
        return msg, kwargs


def make_child_logger(log, **context):
    """Return a logger carrying `log`'s context plus `context`
    (reference bunyan log.child). Accepts a plain Logger, a
    ContextLogger, or None (falls back to the 'cueball' logger)."""
    if log is None:
        log = logging.getLogger('cueball')
    if isinstance(log, logging.LoggerAdapter):
        merged = dict(log.extra or {})
        merged.update(context)
        return ContextLogger(log.logger, merged)
    return ContextLogger(log, dict(context))

# ---------------------------------------------------------------------------
# assert-plus style validation

def _chk(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


# ---------------------------------------------------------------------------
# Error-event metrics (reference lib/utils.js:29-46,395-444)

METRIC_CUEBALL_EVENT_COUNTER = 'cueball_events'

# Whitelist of error events tracked by the shared counter; events outside
# this list are silently ignored (reference lib/utils.js:37-46).
METRIC_ERROR_EVENTS = frozenset([
    'timeout-during-connect',
    'error-during-connect',
    'close-during-connect',
    'error-while-connected',
    'retries-exhausted',
    'claim-timeout',
    'error-while-claimed',
    'failed-state',
])


def create_error_metrics(options: dict) -> 'mod_metrics.Collector':
    """Adopt options['collector'] or create one; idempotently declare the
    cueball_events counter (reference lib/utils.js:395-419)."""
    collector = options.get('collector')
    if collector is None:
        collector = mod_metrics.create_collector(
            labels={'component': 'cueball'})
    collector.counter(
        name=METRIC_CUEBALL_EVENT_COUNTER,
        help='Total number of cueball error events')
    return collector


def update_error_metrics(collector: 'mod_metrics.Collector', uuid: str,
                         err_str: str) -> None:
    """Count a whitelisted error event (reference lib/utils.js:421-444)."""
    if err_str not in METRIC_ERROR_EVENTS:
        return
    # Hostname for a metric label, not byte movement.
    import socket as mod_socket  # cblint: ignore=C110
    counter = collector.get_collector(METRIC_CUEBALL_EVENT_COUNTER)
    counter.increment({
        'hostname': mod_socket.gethostname(),
        'uuid': uuid,
        'type': 'error',
        'evt': err_str,
    })


# ---------------------------------------------------------------------------
# Stack-trace gating (reference lib/utils.js:48-115)
#
# Claim/release stack capture is off by default for performance; turn it on
# with enable_stack_traces() (the dtrace capture-stack probe analogue is a
# process-wide flag plus the FSM transition tracer hooks in fsm.py).

_STACK_TRACES_ENABLED = False


def enable_stack_traces() -> None:
    global _STACK_TRACES_ENABLED
    _STACK_TRACES_ENABLED = True


def disable_stack_traces() -> None:
    global _STACK_TRACES_ENABLED
    _STACK_TRACES_ENABLED = False


def stack_traces_enabled() -> bool:
    return _STACK_TRACES_ENABLED


_FAKE_STACK = ('Error\n at unknown (stack traces disabled)\n'
               ' at unknown (stack traces disabled)\n')


def maybe_capture_stack_trace() -> dict:
    """Return {'stack': str}; a real formatted stack when enabled, else a
    fixed two-frame placeholder (reference lib/utils.js:100-114)."""
    if _STACK_TRACES_ENABLED:
        return {'stack': ''.join(traceback.format_stack(limit=16))}
    return {'stack': _FAKE_STACK}


# ---------------------------------------------------------------------------
# Recovery-spec validation (reference lib/utils.js:116-186)

_RECOVERY_KEYS = frozenset([
    'retries', 'timeout', 'maxTimeout', 'delay', 'maxDelay', 'delaySpread'])

_DAY_MS = 1000 * 3600 * 24


def assert_recovery(obj, name: str | None = None) -> None:
    if name is None:
        name = 'recovery'
    _chk(isinstance(obj, dict), '%s must be a dict' % name)
    unknown = set(obj.keys()) - _RECOVERY_KEYS
    _chk(not unknown, '%s has unknown keys: %r' % (name, sorted(unknown)))

    _chk(_is_num(obj.get('retries')), '%s.retries must be a number' % name)
    _chk(math.isfinite(obj['retries']), '%s.retries must be finite' % name)
    _chk(obj['retries'] >= 0, '%s.retries must be >= 0' % name)

    _chk(_is_num(obj.get('timeout')), '%s.timeout must be a number' % name)
    _chk(math.isfinite(obj['timeout']), '%s.timeout must be finite' % name)
    _chk(obj['timeout'] > 0, '%s.timeout must be > 0' % name)

    max_timeout = obj.get('maxTimeout')
    if max_timeout is not None:
        _chk(_is_num(max_timeout), '%s.maxTimeout must be a number' % name)
        _chk(obj['timeout'] <= max_timeout,
             '%s.maxTimeout must be >= timeout' % name)

    _chk(_is_num(obj.get('delay')), '%s.delay must be a number' % name)
    _chk(math.isfinite(obj['delay']), '%s.delay must be finite' % name)
    _chk(obj['delay'] >= 0, '%s.delay must be >= 0' % name)

    max_delay = obj.get('maxDelay')
    if max_delay is not None:
        _chk(_is_num(max_delay), '%s.maxDelay must be a number' % name)
        _chk(obj['delay'] <= max_delay,
             '%s.maxDelay must be >= delay' % name)

    spread = obj.get('delaySpread')
    if spread is not None:
        _chk(_is_num(spread), '%s.delaySpread must be a number' % name)
        _chk(0.0 <= spread <= 1.0,
             '%s.delaySpread must be between 0.0 and 1.0' % name)

    # Exponential growth caps: with no explicit max, retries must be small
    # enough that delay * 2^retries stays under one day
    # (reference lib/utils.js:162-186).
    if max_delay is None:
        _chk(obj['retries'] < 32,
             '%s.maxDelay is required when retries >= 32' % name)
        _chk(obj['delay'] * (1 << int(obj['retries'])) < _DAY_MS,
             '%s.maxDelay is required with given values of retries and '
             'delay (effective unspecified maxDelay is > 1 day)' % name)
    if max_timeout is None:
        _chk(obj['retries'] < 32,
             '%s.maxTimeout is required when retries >= 32' % name)
        _chk(obj['timeout'] * (1 << int(obj['retries'])) < _DAY_MS,
             '%s.maxTimeout is required with given values of retries and '
             'timeout (effective unspecified maxTimeout is > 1 day)' % name)


def assert_recovery_set(obj) -> None:
    """Validate a map of operation-name -> recovery spec
    (reference lib/utils.js:116-122). Operation names are free-form; the
    framework looks up 'default', 'connect', 'initial', 'dns', 'dns_srv'."""
    _chk(isinstance(obj, dict), 'recovery must be a dict')
    for k, v in obj.items():
        assert_recovery(v, 'recovery.' + k)


def assert_claim_delay(delay) -> None:
    """Validate targetClaimDelay (reference lib/utils.js:188-196)."""
    if delay is None:
        return
    _chk(_is_num(delay), 'options.targetClaimDelay must be a number')
    _chk(math.isfinite(delay), 'options.targetClaimDelay must be finite')
    _chk(delay > 0, 'options.targetClaimDelay > 0')
    _chk(delay == int(delay), 'options.targetClaimDelay must be integral')


# ---------------------------------------------------------------------------
# Clock / randomness seams
#
# Every time read and every random draw the framework makes goes through
# these two process-wide injection points. The defaults are exactly the
# historical behaviour (time.monotonic/time.time and the global `random`
# module, so `random.seed()` still pins the stream the way
# tests/test_runq_conformance.py relies on). A virtual-time harness
# swaps in a VirtualClock plus a seeded random.Random so a seed fully
# determines a run; the tests set one clock and one RNG in this package
# and the JAX package alike to hold the two against each other.

class SystemClock:
    """Default clock: real monotonic + wall time."""

    def monotonic(self) -> float:
        """Seconds, monotonic (time origin unspecified)."""
        return time.monotonic()

    def wall(self) -> float:
        """Seconds since the epoch (time.time)."""
        return time.time()


_clock = SystemClock()
_rng = random  # module default: the global `random` stream


# Consumers that cache clock-derived state (the native trace recorder
# reads CLOCK_MONOTONIC directly unless a virtual clock is installed)
# register here to be told when the clock seam changes.
_clock_hooks: list = []


def add_clock_hook(fn) -> None:
    """Call ``fn(clock)`` after every set_clock(); idempotent."""
    if fn not in _clock_hooks:
        _clock_hooks.append(fn)


def remove_clock_hook(fn) -> None:
    try:
        _clock_hooks.remove(fn)
    except ValueError:
        pass


def set_clock(clock) -> object:
    """Install a process-wide clock (an object with .monotonic() and
    .wall(), both in seconds); returns the previous clock so callers
    can restore it in a finally block."""
    global _clock
    old = _clock
    _clock = clock
    for fn in list(_clock_hooks):
        fn(clock)
    return old


def get_clock():
    return _clock


def set_rng(rng) -> object:
    """Install the process-wide RNG (random.Random-compatible: random /
    randrange / getrandbits / shuffle); returns the previous one. All
    framework randomness — backoff jitter, pool preference inserts,
    DNS resolver shuffle and qid draws, trace ids — flows through
    this seam."""
    global _rng
    old = _rng
    _rng = rng
    return old


def get_rng():
    return _rng


def make_uuid() -> str:
    """A random version-4 UUID string drawn from the RNG seam, so
    pool/set/resolver identities are reproducible under netsim's
    seeded runs (uuid.uuid4() would read os.urandom and make
    otherwise-deterministic trace exports differ run to run)."""
    bits = _rng.getrandbits(128)
    bits = (bits & ~(0xf << 76)) | (0x4 << 76)       # version 4
    bits = (bits & ~(0x3 << 62)) | (0x2 << 62)       # RFC 4122 variant
    h = '%032x' % bits
    return '%s-%s-%s-%s-%s' % (h[:8], h[8:12], h[12:16], h[16:20],
                               h[20:])


def current_millis() -> float:
    """Monotonic time in milliseconds (reference lib/utils.js:198-204),
    read through the pluggable clock seam."""
    return _clock.monotonic() * 1000.0


def wall_time() -> float:
    """Epoch seconds through the pluggable clock seam (the `time.time()`
    every scheduling deadline in the framework uses)."""
    return _clock.wall()


def perf_seconds() -> float:
    """Seconds on the host's high-resolution counter (`time.perf_counter`),
    the one stopwatch of this package. It never reads the clock seam:
    it times real work even under a frozen or virtual clock, as the
    shard jobs' and hops' milliseconds of a router's fleet passes are
    read while the benchmark holds the host clock still."""
    return time.perf_counter()


def shuffle(array: list) -> list:
    """In-place Fisher-Yates shuffle (reference lib/utils.js:207-217)."""
    i = len(array)
    while i > 0:
        j = _rng.randrange(i)
        i -= 1
        array[i], array[j] = array[j], array[i]
    return array


def gen_delay(recov_or_delay, spread: float | None = None) -> int:
    """Randomized retry delay: base * (1 - spread/2 + U(0,1)*spread), i.e.
    uniformly within +/- spread/2 of base; default spread 0.2. Decorrelates
    retry herds across clients (reference lib/utils.js:446-461)."""
    base = recov_or_delay
    if isinstance(recov_or_delay, dict) and spread is None:
        base = recov_or_delay['delay']
        spread = recov_or_delay.get('delaySpread')
    _chk(_is_num(base), 'base delay must be a number')
    if spread is None:
        spread = 0.2
    return round(base * (1 - spread / 2.0 + _rng.random() * spread))


delay = gen_delay


# ---------------------------------------------------------------------------
# planRebalance (reference lib/utils.js:219-393)

def plan_rebalance(connections: dict, dead: dict, target: int, max_: int,
                   singleton: bool = False) -> dict:
    """Pure pool-balance planner.

    Given the current {backend_key: [connection, ...]} map, the dead-backend
    map, the target connection count and the max cap, compute a plan:
    {'add': [backend_key, ...], 'remove': [connection, ...]}.

    Semantics (reference lib/utils.js:239-366, behaviour pinned by the
    test table in reference test/utils.test.js):
    - Want `target` connections spread round-robin over backends in
      preference order (the order of `connections` keys).
    - A dead backend encountered during allocation gets exactly one probe
      connection, and a replacement allocation is queued for each slot it
      would have filled.
    - Replacements round-robin too; a replacement landing on another dead
      backend can itself be replaced, but only while under `max_`, and the
      planner guarantees every backend is tried at least once before
      double-allocating (starvation guard).
    - `singleton` mode (ConnectionSet): at most one connection per backend.
    """
    _chk(isinstance(connections, dict), 'connections must be a dict')
    _chk(_is_num(target), 'target must be a number')
    _chk(_is_num(max_), 'max must be a number')
    _chk(target >= 0, 'target must be >= 0')
    _chk(max_ >= target, 'max must be >= target')

    keys = list(connections.keys())
    wanted: dict[str, int] = {}
    plan = {'add': [], 'remove': []}

    # Pass 1: allocate `target` slots round-robin; dead backends get one
    # probe each and accrue replacement credits.
    done = 0
    replacements = 0
    for _ in range(int(target)):
        if not keys:
            break
        k = keys.pop(0)
        keys.append(k)
        if k not in wanted:
            wanted[k] = 0
        if dead.get(k) is not True:
            if singleton:
                if wanted[k] == 0:
                    wanted[k] = 1
                    done += 1
            else:
                wanted[k] += 1
                done += 1
            continue
        if wanted[k] == 0:
            wanted[k] = 1
            done += 1
        replacements += 1

    # Apply the max cap to replacement credits.
    if done + replacements > max_:
        replacements = int(max_) - done

    # Pass 2: allocate replacements round-robin with the cap-aware
    # starvation guard (reference lib/utils.js:296-366).
    i = 0
    while i < replacements:
        if not keys:
            break
        k = keys.pop(0)
        keys.append(k)
        if k not in wanted:
            wanted[k] = 0
        if dead.get(k) is not True:
            if singleton:
                if wanted[k] == 0:
                    wanted[k] = 1
                    done += 1
                    i += 1
                    continue
            else:
                wanted[k] += 1
                done += 1
                i += 1
                continue

        count = done + replacements - i
        if singleton:
            empties = [kk for kk in keys
                       if dead.get(kk) is not True and kk not in wanted]
        else:
            empties = [kk for kk in keys
                       if dead.get(kk) is not True or kk not in wanted]

        if count + 1 <= max_:
            # Room for both this probe and a further replacement.
            if wanted[k] == 0:
                wanted[k] = 1
                done += 1
            if empties:
                replacements += 1
        elif count <= max_ and empties:
            # Room for only one, but a possibly-live candidate exists:
            # spend the slot there instead.
            replacements += 1
        elif count <= max_:
            # Room for one and everything looks dead: probe this one.
            if wanted[k] == 0:
                wanted[k] = 1
                done += 1
        else:
            break
        i += 1

    # Diff wanted vs. actual. Removals walk backends in reverse preference
    # order and shed the oldest connections first; additions walk in
    # preference order (reference lib/utils.js:368-391).
    rev = list(connections.keys())[::-1]
    for key in rev:
        have = len(connections.get(key) or [])
        want = wanted.get(key, 0)
        lst = list(connections[key])
        while have > want:
            plan['remove'].append(lst.pop(0))
            have -= 1
    for key in connections.keys():
        have = len(connections.get(key) or [])
        want = wanted.get(key, 0)
        while have < want:
            plan['add'].append(key)
            have += 1

    return plan


planRebalance = plan_rebalance
