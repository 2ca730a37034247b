"""Batched EMA/low-pass FIR filtering.

The pool damps shrinkage with a 128-tap EMA FIR sampled at 5 Hz
(reference lib/pool.js:37-100). These are the [pools, taps] batched
forms:

- :func:`fir_apply` — one filter output per pool from its current
  ring-buffer window (the FIRFilter.get() analogue). It launches the
  hand-written CUDA kernel for a CUDA tensor (:func:`fir_apply_cuda`)
  and runs the plain version for a CPU tensor (:func:`fir_apply_plain`).
- :func:`fir_smooth` — full filtered history for offline analysis.
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from .._device import resolve_device


def gen_taps(count: int = 128, tc: float = -0.2,
             device=None) -> torch.Tensor:
    """Normalized EMA taps (reference lib/pool.js:50-76). taps[0] weights
    the newest sample."""
    dev = resolve_device(device)
    taps = torch.exp(tc * torch.arange(count, dtype=torch.float32,
                                       device=dev))
    return taps / torch.sum(taps)


def fir_apply_plain(windows: torch.Tensor,
                    taps: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch form of the FIR kernel, with the kernel's
    arithmetic: out[p] = sum_c windows[p, c] * taps[K-1-c].

    windows: [P, K] ordered oldest->newest; taps: [K] with taps[0] the
    newest-sample weight. Returns [P]."""
    return torch.sum(windows * taps.flip(0), dim=1)


def _check_cuda_args(windows: torch.Tensor, taps: torch.Tensor) -> None:
    if windows.device.type != 'cuda' or taps.device != windows.device:
        raise ValueError(
            'fir_apply_cuda needs windows and taps on one CUDA device, '
            'got %s and %s' % (windows.device, taps.device))
    if windows.dtype != torch.float32 or taps.dtype != torch.float32:
        raise TypeError('fir_apply_cuda takes float32, got %s and %s'
                        % (windows.dtype, taps.dtype))
    if windows.dim() != 2 or taps.dim() != 1 or \
            taps.shape[0] != windows.shape[1] or taps.shape[0] < 1:
        raise ValueError('fir_apply_cuda takes windows [P, K] and taps '
                         '[K] with K >= 1, got %s and %s'
                         % (tuple(windows.shape), tuple(taps.shape)))
    if not (windows.is_contiguous() and taps.is_contiguous()):
        raise ValueError('fir_apply_cuda takes contiguous tensors')


def fir_apply_cuda(windows: torch.Tensor,
                   taps: torch.Tensor) -> torch.Tensor:
    """The FIR matvec as the hand-written kernel in csrc/fir.cu, on
    PyTorch's current stream. Raises for anything the kernel does not
    take; there is no fallback. ``fir_apply_cuda.launches`` counts the
    kernel's launches, from every thread."""
    _check_cuda_args(windows, taps)
    from ..kernels import build

    p, k = windows.shape
    out = torch.empty((p,), dtype=torch.float32, device=windows.device)
    if p == 0:
        return out
    lib = build.load('fir')
    with torch.cuda.device(windows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cb_fir_apply_f32(windows.data_ptr(), taps.data_ptr(),
                                  out.data_ptr(), p, k, stream)
    if rc != 0:
        raise RuntimeError('FIR kernel launch failed: %s'
                           % build.error_string(lib, rc))
    with _launches_lock:
        fir_apply_cuda.launches += 1
    return out


fir_apply_cuda.launches = 0
_launches_lock = threading.Lock()


def fir_apply(windows: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Filter output for each pool: the CUDA kernel for tensors on a
    CUDA device, the plain version for tensors on the CPU."""
    if windows.device.type == 'cpu':
        return fir_apply_plain(windows, taps)
    return fir_apply_cuda(windows, taps)


def fir_smooth(series: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Causal filtered sequence for each pool: series [P, T] -> [P, T],
    zero-padded history at t<K."""
    k = taps.shape[0]
    padded = F.pad(series, (k - 1, 0))
    # windows[p, t, c] = padded[p, t + c]: the K samples ending at t.
    windows = padded.unfold(1, k, 1)                   # [P, T, K]
    return windows @ taps.flip(0)
