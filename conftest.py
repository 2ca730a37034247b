"""A time limit for each phase of every test.

A test whose setup, call or teardown runs over `TEST_TIME_LIMIT_S` fails
by name, and the run goes on with the tests after it in the same process
(an xdist worker included), instead of hanging until the whole run is cut.

pytest loads this file beside `tests/conftest.py`. The limit is one
constant: no option, variable or marker changes it.
"""

import contextlib
import signal
import threading
import time

import pytest

TEST_TIME_LIMIT_S = 300
# asyncio logs and drops an exception raised in a loop callback, so once
# over the limit the alarm fires again every REFIRE_S until one reaches
# the test.
REFIRE_S = 1.0


@contextlib.contextmanager
def time_limit(seconds, what):
    """Fail `what` if the body runs over `seconds` of wall time.

    Arms `ITIMER_REAL` with a `SIGALRM` handler that calls `pytest.fail`,
    then again every `REFIRE_S` until the body ends. On exit the timer is
    disarmed, the earlier handler put back and any earlier timer re-armed
    with what it had left. Signals reach only the main thread, so off it
    this does nothing.
    """
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def _over(signum, frame):
        pytest.fail('%s ran over its %g s limit' % (what, seconds),
                    pytrace=False)

    before = signal.signal(signal.SIGALRM, _over)
    started = time.monotonic()
    earlier, interval = signal.setitimer(signal.ITIMER_REAL, seconds,
                                         REFIRE_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, before)
        if earlier:
            left = earlier - (time.monotonic() - started)
            signal.setitimer(signal.ITIMER_REAL, max(left, 1e-6), interval)


def _limited(phase):
    @pytest.hookimpl(hookwrapper=True)
    def hook(item):
        with time_limit(TEST_TIME_LIMIT_S, '%s %s' % (item.nodeid, phase)):
            yield
    return hook


pytest_runtest_setup = _limited('setup')
pytest_runtest_call = _limited('call')
pytest_runtest_teardown = _limited('teardown')
