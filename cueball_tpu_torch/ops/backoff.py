"""Vectorized exponential-backoff schedules.

The SocketMgr doubles delay/timeout per attempt with caps and a
randomized +/- spread/2 jitter to decorrelate retry herds (reference
lib/connection-fsm.js:361-394, lib/utils.js:446-461). Inputs may be
tensors, arrays or numbers; the result lies on the device of the first
tensor argument, else on ``device`` (None means CUDA).
"""

from __future__ import annotations

import torch

from .._device import as_f32, device_of


def backoff_schedule(delay, max_delay, retries: int, device=None):
    """Per-attempt base delays [N, R]: delay * 2^r clamped to max_delay
    (the deterministic part of the SocketMgr backoff ladder)."""
    dev = device_of(delay, max_delay, device=device)
    delay = as_f32(delay, dev)
    max_delay = as_f32(max_delay, dev)
    growth = torch.exp2(torch.arange(retries, dtype=torch.float32,
                                     device=dev))
    return torch.minimum(delay[:, None] * growth[None, :],
                         max_delay[:, None])


def backoff_at(delay, max_delay, attempt, device=None):
    """Current base delay after `attempt` backoff entries:
    min(delay * 2^attempt, max_delay), the value SocketMgrFSM.sm_delay
    holds after entering state_backoff `attempt` times (reference
    lib/connection-fsm.js:372-380). Elementwise over [N]."""
    dev = device_of(delay, max_delay, attempt, device=device)
    delay = as_f32(delay, dev)
    max_delay = as_f32(max_delay, dev)
    attempt = as_f32(attempt, dev)
    return torch.minimum(delay * torch.exp2(attempt), max_delay)


def spread_delays(base, spread, uniforms, device=None):
    """Apply the randomized spread: base * (1 - spread/2 + u * spread),
    u ~ U(0,1) supplied by the caller (reference lib/utils.js:446-461).
    torch.round rounds half to even, as the reference's jnp.round does."""
    dev = device_of(base, spread, uniforms, device=device)
    base = as_f32(base, dev)
    spread = as_f32(spread, dev)
    uniforms = as_f32(uniforms, dev)
    return torch.round(base * (1.0 - spread / 2.0 + uniforms * spread))
