"""cueball_tpu_torch: the fleet runtime in PyTorch, on CUDA.

The counterpart of the JAX package ``cueball_tpu``'s batched control
laws (``ops``) and its live fleet runtime (``parallel``: the telemetry,
control and health steps and the ``FleetSampler`` that drives them, on
one device or split over a ``Mesh`` of devices in one process),
written in PyTorch, with the FIR matvec as a hand-written CUDA kernel
for Hopper (``csrc/fir.cu``). It imports nothing of ``cueball_tpu``:
the host state the sampler reaches (clock, backend registry, pool
monitor) has its own copy here (``host``, ``monitor``, ``events``).

Entry points run on the CUDA card unless the caller passes
``device='cpu'``; without a card the default raises. Importing the
package builds no kernel: ``kernels.build`` runs nvcc on first use.
``cueball_tpu_torch.entry`` holds the entry point
``entry(device=None)`` and its seeded inputs.
"""

from .ops import (CodelState, backoff_schedule, codel_scan, fir_apply,
                  fir_apply_cuda, fir_smooth, gen_taps, spread_delays)
from .parallel import (FleetInputs, FleetSampler, FleetState, fleet_init,
                       fleet_inputs, fleet_scan, fleet_step,
                       fleet_step_cuda, fleet_step_plain, make_live_step,
                       rebase_state)

__all__ = ['CodelState', 'FleetInputs', 'FleetSampler', 'FleetState',
           'backoff_schedule', 'codel_scan', 'fir_apply', 'fir_apply_cuda',
           'fir_smooth', 'fleet_init', 'fleet_inputs', 'fleet_scan',
           'fleet_step', 'fleet_step_cuda', 'fleet_step_plain', 'gen_taps',
           'make_live_step', 'rebase_state', 'spread_delays']


def api_modules() -> list:
    """The port's public modules: this package and every module under it
    but the private ones (a name part starting with ``_``).
    ``docs/torch_api.md`` names every public name of each
    (``tests/test_torch_docs.py``)."""
    import pkgutil
    return [__name__] + [
        m.name for m in pkgutil.walk_packages(__path__, __name__ + '.')
        if not any(part.startswith('_') for part in m.name.split('.'))]
