"""Seeded fuzzes of the port's host library against the JAX package's:
``utils.plan_rebalance``, ``utils.gen_delay`` under one RNG,
``codel.ControlledDelay`` over a sojourn stream, ``cqueue.Queue`` and an
``FSM`` subclass's deferred ``stateChanged`` order. Every value compares
exactly."""

import asyncio
import random

import pytest

pytest.importorskip('torch')

from cueball_tpu import codel as j_codel  # noqa: E402
from cueball_tpu import cqueue as j_cqueue  # noqa: E402
from cueball_tpu import fsm as j_fsm  # noqa: E402
from cueball_tpu import utils as j_utils  # noqa: E402
from cueball_tpu.netsim.clock import VirtualLoop  # noqa: E402
from cueball_tpu_torch import codel as t_codel  # noqa: E402
from cueball_tpu_torch import cqueue as t_cqueue  # noqa: E402
from cueball_tpu_torch import fsm as t_fsm  # noqa: E402
from cueball_tpu_torch import utils as t_utils  # noqa: E402

SEEDS = (0, 1, 2, 3)


class FrozenClock:
    """A clock that moves only when the test moves it."""

    def __init__(self, ms=1000.0):
        self.ms = ms

    def monotonic(self):
        return self.ms / 1000.0

    def wall(self):
        return 1.7e9 + self.ms / 1000.0


@pytest.fixture
def both_clocks():
    """One frozen clock set in both packages; restored after."""
    clock = FrozenClock()
    old = j_utils.set_clock(clock), t_utils.set_clock(clock)
    yield clock
    j_utils.set_clock(old[0])
    t_utils.set_clock(old[1])


@pytest.mark.parametrize('seed', SEEDS)
def test_plan_rebalance_matches_jax(seed):
    rng = random.Random(seed)
    for _ in range(300):
        keys = ['b%d' % i for i in range(rng.randrange(0, 7))]
        conns = {k: [object() for _ in range(rng.randrange(0, 4))]
                 for k in keys}
        dead = {k: True for k in keys if rng.random() < 0.4}
        target = rng.randrange(0, 9)
        max_ = target + rng.randrange(0, 5)
        singleton = rng.random() < 0.25
        want = j_utils.plan_rebalance(conns, dead, target, max_, singleton)
        got = t_utils.plan_rebalance(conns, dead, target, max_, singleton)
        assert got['add'] == want['add']
        assert [id(c) for c in got['remove']] == \
            [id(c) for c in want['remove']]


@pytest.mark.parametrize('seed', SEEDS)
def test_gen_delay_matches_jax_under_one_rng(seed):
    old = (j_utils.set_rng(random.Random(seed)),
           t_utils.set_rng(random.Random(seed)))
    try:
        draws = random.Random(seed + 100)
        for _ in range(500):
            base = draws.choice([0, 1, 50, 250, 1000, 5000.5])
            if draws.random() < 0.3:
                args = ({'delay': base,
                         'delaySpread': draws.choice([None, 0.0, 0.5])},)
            else:
                args = (base, draws.choice([None, 0.2, 1.0]))
            assert t_utils.gen_delay(*args) == j_utils.gen_delay(*args)
        assert t_utils.make_uuid() == j_utils.make_uuid()
    finally:
        j_utils.set_rng(old[0])
        t_utils.set_rng(old[1])


@pytest.mark.parametrize('seed', SEEDS)
def test_controlled_delay_matches_jax(seed, both_clocks):
    rng = random.Random(seed)
    target = rng.choice([5, 50, 100.0, 300])
    jcd = j_codel.ControlledDelay(target)
    tcd = t_codel.ControlledDelay(target)
    decisions = []
    for _ in range(2000):
        both_clocks.ms += rng.choice([0.0, 0.5, 3.0, 10.0, 40.0])
        op = rng.random()
        if op < 0.05:
            jcd.empty()
            tcd.empty()
        elif op < 0.07:
            new = rng.choice([1.0, 20.0, 250.0])
            jcd.set_target(new)
            tcd.set_target(new)
        else:
            start = both_clocks.ms - rng.expovariate(1.0 / (2 * target))
            want = jcd.overloaded(start)
            assert tcd.overloaded(start) == want
            decisions.append(want)
        assert tcd.get_max_idle() == jcd.get_max_idle()
        assert vars(tcd) == vars(jcd)
    assert any(decisions) and not all(decisions)


@pytest.mark.parametrize('seed', SEEDS)
def test_queue_matches_jax(seed):
    rng = random.Random(seed)
    jq, tq = j_cqueue.Queue(), t_cqueue.Queue()
    jnodes, tnodes = [], []
    for i in range(600):
        op = rng.random()
        if op < 0.45:
            jnodes.append(jq.push(i))
            tnodes.append(tq.push(i))
        elif op < 0.7:
            assert tq.shift() == jq.shift()
        elif op < 0.9 and jnodes:
            k = rng.randrange(len(jnodes))
            jn, tn = jnodes.pop(k), tnodes.pop(k)
            assert tn.is_queued() == jn.is_queued()
            if jn.is_queued():
                jn.remove()
                tn.remove()
        else:
            assert tq.peek() == jq.peek()
        assert len(tq) == len(jq) and tq.is_empty() == jq.is_empty()
        assert list(tq) == list(jq)
    seen = []
    tq.for_each(seen.append)
    assert seen == list(jq)


def walker(fsm_mod):
    """A small FSM over states a..d whose entries chain further moves
    from inside an entry, from an immediate, from a timer and from an
    emitted event."""

    class Walker(fsm_mod.FSM):
        def __init__(self, rng, log):
            self.rng = rng
            self.log = log
            super().__init__('a')

        def state_a(self, S):
            self.log.append('enter a')
            S.on(self, 'go', S.gotoState)

        def state_b(self, S):
            self.log.append('enter b')
            if self.rng.random() < 0.5:
                S.gotoState('c')       # re-entrant, from the entry
            else:
                S.immediate(lambda: S.gotoState('d'))

        def state_c(self, S):
            self.log.append('enter c')
            S.validTransitions(['a', 'd'])
            S.timeout(self.rng.choice([0, 1, 5]), lambda: S.gotoState('d'))
            S.on(self, 'go', S.gotoState)

        def state_d(self, S):
            self.log.append('enter d')
            S.gotoStateTimeout(self.rng.choice([1, 2]), 'a')

    return Walker


@pytest.mark.parametrize('seed', SEEDS)
def test_fsm_state_changed_order_matches_jax(seed):
    """Three walkers driven by one seeded script on a virtual-time loop
    (timers fire in deadline order, nothing sleeps): the interleaved
    entries and deferred ``stateChanged`` deliveries, the final states
    and the histories agree."""
    async def run(fsm_mod):
        rng = random.Random(seed)
        log = []
        fsms = [walker(fsm_mod)(rng, log) for _ in range(3)]
        for i, f in enumerate(fsms):
            f.on('stateChanged', lambda st, i=i: log.append((i, st)))
        for _ in range(40):
            f = fsms[rng.randrange(3)]
            if f.is_in_state('a') or f.is_in_state('c'):
                f.emit('go', rng.choice(['a', 'd']) if
                       f.is_in_state('c') else 'b')
            for _ in range(rng.randrange(0, 3)):
                await asyncio.sleep(0)
            if rng.random() < 0.2:
                await asyncio.sleep(0.003)
        await asyncio.sleep(0.01)
        return log, [f.get_state() for f in fsms], \
            [f.get_history() for f in fsms]

    def on_virtual_time(fsm_mod):
        loop = VirtualLoop()
        try:
            return loop.run_until_complete(run(fsm_mod))
        finally:
            loop.close()

    want = on_virtual_time(j_fsm)
    got = on_virtual_time(t_fsm)
    assert got == want
    assert sum(isinstance(e, tuple) for e in want[0]) > 10
