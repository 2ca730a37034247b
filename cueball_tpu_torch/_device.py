"""Device selection shared by the port's entry points.

Every function that creates tensors takes ``device=``. Left as None it
means the CUDA card; a caller that wants the CPU says so. There is no
quiet fallback: without a card, the default raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means CUDA, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'cueball_tpu_torch runs on CUDA by default and no CUDA '
                'device is available; pass device="cpu" to run on the CPU')
        return torch.device('cuda')
    return torch.device(device)


def device_of(*values, device=None) -> torch.device:
    """The device of the first tensor among ``values``, else
    ``resolve_device(device)``."""
    for v in values:
        if isinstance(v, torch.Tensor):
            return v.device
    return resolve_device(device)


def as_f32(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)
