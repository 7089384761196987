"""Percentiles and means over a whole sample (no chunking)."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0..100) by linear interpolation between
    closest ranks (numpy's default): over every value given."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of an empty sample")
    if len(xs) == 1:
        return xs[0]
    r = (len(xs) - 1) * q / 100.0
    lo = math.floor(r)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (r - lo)


def mean(values: Sequence[float]) -> float:
    xs = [float(v) for v in values]
    if not xs:
        raise ValueError("mean of an empty sample")
    return sum(xs) / len(xs)
