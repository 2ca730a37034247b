"""The float → int32 cast of the JAX package, on any device.

XLA's f32 → s32 convert saturates, and ``jnp.astype(jnp.int32)`` is
that convert. torch's ``.to(torch.int32)`` is C's cast, which is
undefined out of range: on the CPU it gives -2147483648 for NaN, ±inf
and every finite value outside the int32 range. The port's float →
int32 casts therefore go through :func:`to_int32_xla`.
"""

from __future__ import annotations

import torch

__all__ = ['to_int32_xla']

_I32_MIN = -2147483648.0
_I32_MAX = 2147483647.0


def to_int32_xla(x: torch.Tensor) -> torch.Tensor:
    """``x`` cast to int32 by XLA's saturating rule, on ``x``'s device:

    - NaN → 0;
    - x ≥ 2^31, and +inf → 2147483647;
    - x ≤ -2^31, and -inf → -2147483648;
    - anything else truncates toward zero.

    The JAX package casts so at ``cueball_tpu/parallel/control.py:185``
    (``plan_target``), ``:189-191`` (``plan_spares`` and the rounded raw
    target of ``delta``) and ``cueball_tpu/parallel/health.py:194-196``
    (``score``). The clamp runs in float64, where every float32 value
    and both int32 bounds are exact; 2147483647 is not a float32."""
    wide = torch.nan_to_num(x.to(torch.float64), nan=0.0)
    return wide.clamp(_I32_MIN, _I32_MAX).to(torch.int32)
