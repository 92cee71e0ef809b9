"""The percentile and rate arithmetic of the end-to-end metrics.

Frozen here so that a later change to the port cannot move the yardstick.
The percentile is numpy's default ("linear": the value at rank
p/100 * (n - 1), interpolated between its two neighbours), written out so
that it does not depend on numpy's version.
"""

from __future__ import annotations

import math
from typing import Dict, Hashable, Sequence


def percentile(values: Sequence[float], p: float) -> float:
    """The p-th percentile (0..100) of `values`, linear between ranks."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    rank = p / 100.0 * (len(xs) - 1)
    lo = math.floor(rank)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (rank - lo)


def median(values: Sequence[float]) -> float:
    return percentile(values, 50.0)


def latencies_ms(submitted: Dict[Hashable, float], completed: Dict[Hashable, float]):
    """Milliseconds from each completed key's submit to its completion."""
    return [1000.0 * (completed[k] - submitted[k]) for k in completed]


def rate(n_done: int, window_s: float) -> float:
    """Work completed per second over the whole window."""
    if window_s <= 0:
        raise ValueError("an empty window")
    return n_done / window_s
