"""The fleet runtime on one device, the counterpart of
``cueball_tpu.parallel``: the telemetry step (``telemetry``), the
control step (``control``), the health step and its monitor
(``health``), and the live sampler that drives them (``sampler``).
The multi-device forms are not ported yet."""

from .control import (ControlInputs, ControlState, apply_decisions,
                      control_init, control_inputs, control_step,
                      make_control_step, reduce_control)
from .health import (DEFAULT_OBJECTIVES, BackendTable, HealthInputs,
                     HealthMonitor, HealthState, SLOObjectives,
                     active_monitors, health_init, health_inputs,
                     health_snapshot, health_step, latency_bucket,
                     make_health_step, reduce_health)
from .sampler import FleetSampler, TelemetryRowHandle, reduce_fleet
from .telemetry import (FleetInputs, FleetState, LiveStep, fleet_init,
                        fleet_inputs, fleet_scan, fleet_step,
                        fleet_step_cuda, fleet_step_plain,
                        fold_backend_slots, make_live_step, rebase_state)

__all__ = ['BackendTable', 'ControlInputs', 'ControlState',
           'DEFAULT_OBJECTIVES', 'FleetInputs', 'FleetSampler',
           'FleetState', 'HealthInputs', 'HealthMonitor', 'HealthState',
           'LiveStep', 'SLOObjectives', 'TelemetryRowHandle',
           'active_monitors', 'apply_decisions', 'control_init',
           'control_inputs', 'control_step', 'fleet_init', 'fleet_inputs',
           'fleet_scan', 'fleet_step', 'fleet_step_cuda',
           'fleet_step_plain', 'fold_backend_slots', 'health_init',
           'health_inputs', 'health_snapshot', 'health_step',
           'latency_bucket', 'make_control_step', 'make_health_step',
           'make_live_step', 'rebase_state', 'reduce_control',
           'reduce_fleet', 'reduce_health']
