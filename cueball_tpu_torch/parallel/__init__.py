"""The fleet runtime, the counterpart of ``cueball_tpu.parallel``: the
telemetry step (``telemetry``), the control step (``control``), the
health step and its monitor (``health``), and the live sampler that
drives them (``sampler``), on one device or split over the shards of a
``Mesh`` of devices (``mesh``)."""

from .control import (ControlInputs, ControlState, apply_decisions,
                      control_init, control_inputs, control_step,
                      make_control_step, make_shardmap_control_step,
                      reduce_control)
from .health import (DEFAULT_OBJECTIVES, BackendTable, HealthInputs,
                     HealthMonitor, HealthState, SLOObjectives,
                     active_monitors, health_init, health_inputs,
                     health_snapshot, health_step, latency_bucket,
                     make_health_step, make_shardmap_health_step,
                     reduce_health)
from .mesh import Mesh
from .sampler import FleetSampler, TelemetryRowHandle, reduce_fleet
from .telemetry import (FleetInputs, FleetState, LiveStep, MeshStep,
                        fleet_init, fleet_inputs, fleet_scan, fleet_step,
                        fleet_step_cuda, fleet_step_plain,
                        fold_backend_slots, make_live_step,
                        make_sharded_scan, make_sharded_step,
                        make_shardmap_step, rebase_state, shard_inputs,
                        shard_state, shard_window)

__all__ = ['BackendTable', 'ControlInputs', 'ControlState',
           'DEFAULT_OBJECTIVES', 'FleetInputs', 'FleetSampler',
           'FleetState', 'HealthInputs', 'HealthMonitor', 'HealthState',
           'LiveStep', 'Mesh', 'MeshStep', 'SLOObjectives',
           'TelemetryRowHandle', 'active_monitors', 'apply_decisions',
           'control_init', 'control_inputs', 'control_step', 'fleet_init',
           'fleet_inputs', 'fleet_scan', 'fleet_step', 'fleet_step_cuda',
           'fleet_step_plain', 'fold_backend_slots', 'health_init',
           'health_inputs', 'health_snapshot', 'health_step',
           'latency_bucket', 'make_control_step', 'make_health_step',
           'make_live_step', 'make_sharded_scan', 'make_sharded_step',
           'make_shardmap_control_step', 'make_shardmap_health_step',
           'make_shardmap_step', 'rebase_state', 'reduce_control',
           'reduce_fleet', 'reduce_health', 'shard_inputs', 'shard_state',
           'shard_window']
