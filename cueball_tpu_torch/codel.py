"""CoDel constants the fleet control plane needs, the counterpart of
``cueball_tpu/codel.py:27-28``.

Bounds on any externally set CoDel target: the control step never
drives a pool's target to 0 (drop everything) or unbounded (shed
nothing)."""

CODEL_TARGET_MIN = 1.0
CODEL_TARGET_MAX = 60_000.0
