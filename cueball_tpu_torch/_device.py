"""Device selection shared by the port's entry points, and the copy of
a step's scalar results to the host.

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


def to_host_values(tensors: dict) -> dict:
    """0-dim tensors as Python numbers, with one device-to-host copy for
    all of them: ints for integer tensors, bools for bool tensors,
    floats for float tensors (the float64 stack holds each float32 and
    int32 value exactly)."""
    names = list(tensors)
    if not names:
        return {}
    vals = torch.stack([tensors[k].to(torch.float64)
                        for k in names]).cpu().tolist()
    out = {}
    for name, v in zip(names, vals):
        dtype = tensors[name].dtype
        if dtype == torch.bool:
            out[name] = bool(v)
        elif dtype.is_floating_point:
            out[name] = v
        else:
            out[name] = int(v)
    return out
