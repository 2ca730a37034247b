"""Batched CoDel control law over Q queues.

The same controlled-delay algorithm the pool runs per claim queue
(reference lib/codel.js), as dense [Q] tensors that advance in lockstep
through T dequeue events, carrying (first_above_time, drop_next, count,
dropping). All branching is torch.where, so one step is a fixed
sequence of elementwise ops. Timestamps are float32: callers pass the
clock as a float32 tensor so the comparisons and sums round exactly as
the JAX reference's do.
"""

from __future__ import annotations

import typing

import torch

from .._device import resolve_device

CODEL_INTERVAL = 100.0  # ms (reference lib/codel.js:16)


class CodelState(typing.NamedTuple):
    first_above: torch.Tensor  # [Q] ms timestamp, 0 = unset
    drop_next: torch.Tensor    # [Q] ms timestamp
    count: torch.Tensor        # [Q] drops in current dropping run
    dropping: torch.Tensor     # [Q] bool


def codel_init(num_queues: int, device=None) -> CodelState:
    """Four separate zero tensors, so an in-place update of one leaf
    never shows through another."""
    dev = resolve_device(device)

    def z():
        return torch.zeros((num_queues,), dtype=torch.float32, device=dev)
    return CodelState(z(), z(), z(),
                      torch.zeros((num_queues,), dtype=torch.bool,
                                  device=dev))


def _step(target: torch.Tensor, state: CodelState, inputs):
    now, sojourn = inputs  # now: 0-dim float32 ms; sojourn: [Q] ms

    below = sojourn < target
    first_unset = state.first_above == 0.0
    # can_drop per reference lib/codel.js:34-46
    new_first = torch.where(
        below, 0.0,
        torch.where(first_unset, now + CODEL_INTERVAL, state.first_above))
    ok_to_drop = (~below) & (~first_unset) & (now >= state.first_above)

    # dropping branch (reference lib/codel.js:62-68)
    leave_dropping = state.dropping & ~ok_to_drop
    drop_in_run = state.dropping & ok_to_drop & (now >= state.drop_next)
    count_a = torch.where(drop_in_run, state.count + 1, state.count)

    # enter-dropping branch (reference lib/codel.js:69-85)
    recent = (now - state.drop_next) < CODEL_INTERVAL
    long_above = (now - state.first_above) >= CODEL_INTERVAL
    enter = (~state.dropping) & ok_to_drop & (recent | long_above)
    count_b = torch.where(
        enter,
        torch.where(recent & (count_a > 2), count_a - 2, 1.0),
        count_a)
    # drop_next moves only on entering a dropping run; an in-run drop
    # bumps count but NOT drop_next (reference lib/codel.js:62-68).
    drop_next = torch.where(
        enter,
        now + CODEL_INTERVAL / torch.sqrt(torch.clamp_min(count_b, 1.0)),
        state.drop_next)

    dropping = (state.dropping & ~leave_dropping) | enter
    drop = drop_in_run | enter

    return CodelState(new_first, drop_next, count_b, dropping), drop


def codel_scan(sojourns: torch.Tensor, times: torch.Tensor,
               target: float, state: CodelState | None = None):
    """Run CoDel over a trace.

    sojourns: [T, Q] float32 queue sojourn times (ms) at each dequeue
    event; times: [T] float32 monotonic ms clock; target: ms. Returns
    (final_state, drops [T, Q] bool).
    """
    if state is None:
        state = codel_init(sojourns.shape[1], device=sojourns.device)
    tgt = torch.tensor(target, dtype=torch.float32, device=sojourns.device)
    drops = []
    for t in range(sojourns.shape[0]):
        state, drop = _step(tgt, state, (times[t], sojourns[t]))
        drops.append(drop)
    if drops:
        return state, torch.stack(drops)
    return state, torch.zeros(sojourns.shape, dtype=torch.bool,
                              device=sojourns.device)
