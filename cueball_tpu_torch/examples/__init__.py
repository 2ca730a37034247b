"""Runnable examples of the port, the counterparts of the JAX
package's ``examples/telemetry_replay.py`` and
``examples/fleet_mesh_sampler.py``:

    python -m cueball_tpu_torch.examples.telemetry_replay [--device cpu]
    python -m cueball_tpu_torch.examples.fleet_mesh_sampler [--device cpu]

Both run on the CUDA card by default (and raise without one); each
module's ``main(device=None)`` runs it in-process.
"""
