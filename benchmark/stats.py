"""Order statistics over every sample of a window, and the union of
intervals that device-busy time is taken from."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float | None:
    """The ``q``-th percentile (0-100) of all ``values``, by linear
    interpolation between the two nearest ranks (numpy's default
    method); None for no values."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def mean(values) -> float | None:
    xs = list(values)
    return sum(xs) / len(xs) if xs else None


def union(intervals) -> list:
    """The union of ``(start, end)`` intervals as sorted disjoint
    intervals."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def clip(intervals, lo: float, hi: float) -> list:
    """``intervals`` cut to ``[lo, hi]``."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)
