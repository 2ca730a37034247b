"""Carry fleet, control and health state and inputs between numpy and
the port.

A state or inputs tuple from any source (for example the JAX package's,
turned into numpy arrays leaf by leaf) becomes the port's tensors with
the port's dtypes, so two implementations can step from an identical
state; :func:`to_numpy` goes the other way. The ``*_near_boundary``
masks name the rows where two correct implementations may round a
decision differently.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .ops.codel_batch import CodelState
from .parallel.control import ControlInputs, ControlState
from .parallel.health import (INPUT_DTYPES, SCORE_SCALE, STATE_DTYPES,
                              HealthInputs, HealthState)
from .parallel.telemetry import FleetInputs, FleetState


def _t(x, dtype, device):
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def fleet_state_from_numpy(state, device=None) -> FleetState:
    """A FleetState from anything with FleetState's fields holding
    arrays (``windows``, ``codel.{first_above, drop_next, count,
    dropping}``, ``now_ms``)."""
    dev = resolve_device(device)
    f32 = torch.float32
    c = state.codel
    return FleetState(
        windows=_t(state.windows, f32, dev),
        codel=CodelState(first_above=_t(c.first_above, f32, dev),
                         drop_next=_t(c.drop_next, f32, dev),
                         count=_t(c.count, f32, dev),
                         dropping=_t(c.dropping, torch.bool, dev)),
        now_ms=_t(state.now_ms, f32, dev))


def fleet_inputs_from_numpy(inp, device=None) -> FleetInputs:
    """A FleetInputs from anything with FleetInputs' fields holding
    arrays; `active` and `reset` become bool, the rest float32."""
    dev = resolve_device(device)
    return FleetInputs(**{
        name: _t(getattr(inp, name),
                 torch.bool if name in ('active', 'reset')
                 else torch.float32, dev)
        for name in FleetInputs._fields})


def control_state_from_numpy(state, device=None) -> ControlState:
    """A ControlState from anything with its fields holding arrays."""
    dev = resolve_device(device)
    return ControlState(targets=_t(state.targets, torch.float32, dev),
                        epoch=_t(state.epoch, torch.int32, dev),
                        now_ms=_t(state.now_ms, torch.float32, dev))


def control_inputs_from_numpy(inp, device=None) -> ControlInputs:
    """A ControlInputs from anything with its fields holding arrays;
    `active` and `reset` become bool, the rest float32."""
    dev = resolve_device(device)
    return ControlInputs(**{
        name: _t(getattr(inp, name),
                 torch.bool if name in ('active', 'reset')
                 else torch.float32, dev)
        for name in ControlInputs._fields})


def health_state_from_numpy(state, device=None) -> HealthState:
    """A HealthState from anything with its fields holding arrays, each
    cast to the port's dtype for it."""
    dev = resolve_device(device)
    return HealthState(**{name: _t(getattr(state, name), dtype, dev)
                          for name, dtype in STATE_DTYPES.items()})


def health_inputs_from_numpy(inp, device=None) -> HealthInputs:
    """A HealthInputs from anything with its fields holding arrays, each
    cast to the port's dtype for it."""
    dev = resolve_device(device)
    return HealthInputs(**{name: _t(getattr(inp, name), dtype, dev)
                           for name, dtype in INPUT_DTYPES.items()})


def to_numpy(tree):
    """Every tensor in a tree of NamedTuples, dicts, lists and tuples as
    a numpy array on the host, the tree's shape kept."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree


def target_near_boundary(filtered: np.ndarray, samples: np.ndarray,
                         spares: np.ndarray,
                         eps: float = 1e-4) -> np.ndarray:
    """Bool mask of the rows whose `target` and `clamped` can flip when
    `filtered` moves by a rounding error: `filtered` within `eps` of an
    integer (where its ceil changes), or the raw target within `eps` of
    1.05 times that ceil (where the clamp changes). Two FIR
    implementations that sum in different orders agree on `target`
    exactly off these rows."""
    frac = filtered - np.floor(filtered)
    near_int = (frac < eps) | (frac > 1.0 - eps)
    near_clamp = np.abs(samples + spares - np.ceil(filtered) * 1.05) < eps
    return near_int | near_clamp


def health_score_near_boundary(ewma: np.ndarray,
                               eps: float = 1e-4) -> np.ndarray:
    """Bool mask of the backends whose integer `score` can flip when
    `ewma` moves by a rounding error: ``16 * log2(1 + ewma)`` within
    `eps` of a half-integer, where the rounding to the score changes.
    Two health steps whose EWMA or log2 round differently agree on
    `score`, and so on the verdicts, exactly off these rows. A NaN or
    infinite ``16 * log2(1 + ewma)`` (an EWMA that is NaN, infinite or
    at most -1) is on no boundary: both casts saturate it alike."""
    with np.errstate(invalid='ignore', divide='ignore'):
        x = SCORE_SCALE * np.log2(1.0 + np.asarray(ewma, np.float64))
        return np.abs(x - np.floor(x) - 0.5) < eps
