"""Arithmetic of the metrics: quantiles, and time on the device from
intervals that may overlap."""
from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def percentile(values: Sequence[float], q: int) -> float:
    """The ``q``-th percentile of every value, by the inclusive method
    of ``statistics.quantiles(values, n=100)``: over all samples, so a
    stall anywhere in the window can move it."""
    vals = list(values)
    if not vals:
        raise ValueError("no samples")
    if len(vals) == 1:
        return float(vals[0])
    return float(statistics.quantiles(vals, n=100, method="inclusive")[q - 1])


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The intervals merged where they overlap or touch, in order."""
    merged: List[Interval] = []
    for a, b in sorted(intervals):
        if b < a:
            raise ValueError(f"interval ends before it starts: {(a, b)}")
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def clip(intervals: Iterable[Interval], lo: float, hi: float
         ) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def busy(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    """Time in [lo, hi] during which at least one interval is open:
    overlapping operations count once."""
    return sum(b - a for a, b in union(clip(intervals, lo, hi)))


def gaps(intervals: Iterable[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """The stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for a, b in union(clip(intervals, lo, hi)):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out
