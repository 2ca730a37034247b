"""The per-test time limit of the repo's root `conftest.py`.

The module is loaded by path under a name of its own, so these tests hold
its `time_limit` directly and never touch the `conftest` that pytest
registered.
"""

import asyncio
import contextlib
import importlib.util
import os
import signal
import threading
import time

import pytest

_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'conftest.py')
_spec = importlib.util.spec_from_file_location('_root_conftest_limits', _PATH)
limits = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(limits)


def _busy(seconds):
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        pass


@contextlib.contextmanager
def own_alarm():
    """The test's own earlier SIGALRM handler, with no timer armed; the
    run's own handler and timer (the root conftest's limit on this test's
    call) are put back after. Used inside the test's body: each phase's
    limit puts back the handler that was there before it."""
    def earlier(signum, frame):
        raise AssertionError('the earlier SIGALRM handler ran')
    run_handler = signal.signal(signal.SIGALRM, earlier)
    started = time.monotonic()
    run_timer, run_interval = signal.setitimer(signal.ITIMER_REAL, 0)
    try:
        yield earlier
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, run_handler)
        if run_timer:
            left = run_timer - (time.monotonic() - started)
            signal.setitimer(signal.ITIMER_REAL, max(left, 1e-6),
                             run_interval)


@pytest.mark.parametrize('earlier_s', [0.0, 60.0],
                         ids=['no-earlier-timer', 'earlier-timer-60s'])
@pytest.mark.parametrize('body_s', [5.0, 0.01], ids=['overruns', 'in-time'])
def test_limit_fails_an_overrun_and_puts_back_the_earlier_alarm(
        body_s, earlier_s):
    with own_alarm() as earlier:
        signal.setitimer(signal.ITIMER_REAL, earlier_s)
        started = time.monotonic()
        if body_s > 0.2:
            with pytest.raises(
                    pytest.fail.Exception,
                    match=r'^busy loop ran over its 0\.2 s limit$'):
                with limits.time_limit(0.2, 'busy loop'):
                    _busy(body_s)
        else:
            with limits.time_limit(0.2, 'busy loop'):
                _busy(body_s)
        took = time.monotonic() - started
        left, interval = signal.getitimer(signal.ITIMER_REAL)
        handler = signal.getsignal(signal.SIGALRM)

    assert took < 1.0
    assert handler is earlier
    assert interval == 0.0
    if earlier_s:
        assert earlier_s - took - 0.05 <= left <= earlier_s
    else:
        assert left == 0.0


def test_the_alarm_fires_again_after_asyncio_drops_a_failure():
    async def main():
        # The first alarm lands in this callback; asyncio logs and drops
        # the failure, and the loop goes on waiting.
        asyncio.get_running_loop().call_soon(_busy, 0.5)
        await asyncio.sleep(5.0)

    with own_alarm():
        started = time.monotonic()
        with pytest.raises(pytest.fail.Exception,
                           match=r'^loop ran over its 0\.2 s limit$'):
            with limits.time_limit(0.2, 'loop'):
                asyncio.run(main())
        took = time.monotonic() - started

    assert 0.2 + limits.REFIRE_S <= took < 0.2 + limits.REFIRE_S + 0.5


def test_off_the_main_thread_it_does_nothing():
    seen = {}

    def body():
        try:
            with limits.time_limit(0.05, 'thread'):
                seen['timer'] = signal.getitimer(signal.ITIMER_REAL)
                seen['handler'] = signal.getsignal(signal.SIGALRM)
                time.sleep(0.3)
            seen['ended'] = True
        except BaseException as exc:  # a failure must reach the assert
            seen['raised'] = exc

    with own_alarm() as earlier:
        thread = threading.Thread(target=body)
        thread.start()
        thread.join(5.0)

    assert seen.get('raised') is None
    assert seen.get('ended') is True
    assert seen['timer'] == (0.0, 0.0)
    assert seen['handler'] is earlier


@pytest.fixture
def setup_timer():
    return signal.getitimer(signal.ITIMER_REAL)


def test_setup_and_call_run_under_the_300_s_limit(setup_timer):
    assert limits.TEST_TIME_LIMIT_S == 300
    for left, interval in (setup_timer,
                           signal.getitimer(signal.ITIMER_REAL)):
        assert 290.0 < left <= 300.0
        assert interval == limits.REFIRE_S
