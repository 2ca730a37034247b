"""The least bytes a fleet tick's device work needs, from its shapes,
and the table of device peaks the roofline shares are taken against.

The count is the same whatever implements the work: every input read
once, every output and carried state written once.

- live step: the [P, K] float32 ring read once and written once; the
  nine float32 and two bool input columns read once; the CoDel state
  (three float32 columns and a bool) read and written; the outputs
  ``filtered``, ``target``, ``retry_backoff`` (float32) and ``clamped``,
  ``drop`` (bool) written;
- control step: the carried float32 target read and written; the four
  decision columns (a float32 and three int32) written; its inputs are
  the live step's, already counted;
- health step, over the backends that carry traffic (the unattributed
  row included): the EWMA, two int32 streaks and the gray bit read and
  written, the [B, 64] float32 sketch read and written; the float32
  latency sum, four int32 columns, two [B, 64] int32 sketches and three
  bool masks read; the verdicts (gray, z, score, EWMA) written.

At P = 1,048,576 and K = 128 the live step's FIR part alone (the ring
read once, one float32 out per row) is 540.0 MB, 0.16151 ms at the
peak below; the ring's read and write at P = 65,536 are 67.1 MB.
"""

from __future__ import annotations

F32 = I32 = 4
BOOL = 1
LAT_BINS = 64

#: Device name -> peak HBM bytes/s, from NVIDIA's data sheet (SXM part,
#: at the full 700 W power limit).
PEAK_BYTES_PER_S = {
    'NVIDIA H100 80GB HBM3': 3.35e12,
}


def ring_bytes(pools: int, taps: int) -> int:
    """The [P, K] float32 ring read once and written once."""
    return 2 * pools * taps * F32


def live_bytes(pools: int, taps: int) -> int:
    per_row = (9 * F32 + 2 * BOOL            # inputs
               + 2 * (3 * F32 + BOOL)        # CoDel state in and out
               + 3 * F32 + 2 * BOOL)         # outputs
    return ring_bytes(pools, taps) + pools * per_row


def control_bytes(pools: int) -> int:
    return pools * (2 * F32 + F32 + 3 * I32)


def health_bytes(backends: int) -> int:
    state = F32 + 2 * I32 + BOOL + LAT_BINS * F32
    inputs = F32 + 4 * I32 + 2 * LAT_BINS * I32 + 3 * BOOL
    verdicts = BOOL + F32 + I32 + F32
    return backends * (2 * state + inputs + verdicts)


def tick_bytes(pools: int, taps: int, backends: int, control: bool = True,
               health: bool = True) -> int:
    """The least bytes one sampler tick's device work needs."""
    total = live_bytes(pools, taps)
    if control:
        total += control_bytes(pools)
    if health:
        total += health_bytes(backends)
    return total


def fir_bytes(pools: int, taps: int) -> int:
    """The FIR alone: the ring read once, one float32 out per row."""
    return pools * taps * F32 + pools * F32
