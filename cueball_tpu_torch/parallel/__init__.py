"""Fleet telemetry on one device, the counterpart of
``cueball_tpu.parallel.telemetry``. The control and health steps, the
sampler and the multi-device forms are not ported yet."""

from .telemetry import (FleetInputs, FleetState, LiveStep, fleet_init,
                        fleet_inputs, fleet_scan, fleet_step,
                        fleet_step_cuda, fleet_step_plain,
                        fold_backend_slots, make_live_step, rebase_state)

__all__ = ['FleetInputs', 'FleetState', 'LiveStep', 'fleet_init',
           'fleet_inputs', 'fleet_scan', 'fleet_step', 'fleet_step_cuda',
           'fleet_step_plain', 'fold_backend_slots', 'make_live_step',
           'rebase_state']
