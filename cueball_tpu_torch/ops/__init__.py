"""Batched PyTorch implementations of the framework's numeric control
algorithms, the counterparts of ``cueball_tpu.ops``.

- ops.fir: the 128-tap EMA low-pass filter (reference lib/pool.js:37-100),
  with the hand-written CUDA kernel ``fir_apply_cuda``
- ops.backoff: exponential backoff schedules with randomized spread
  (reference lib/connection-fsm.js:361-394, lib/utils.js:446-461)
- ops.codel_batch: the CoDel control law stepped over a trace
  (reference lib/codel.js)
"""

from .fir import gen_taps, fir_apply, fir_smooth, fir_apply_cuda
from .backoff import backoff_schedule, spread_delays
from .codel_batch import codel_scan, CodelState

__all__ = ['gen_taps', 'fir_apply', 'fir_smooth', 'fir_apply_cuda',
           'backoff_schedule', 'spread_delays', 'codel_scan',
           'CodelState']
