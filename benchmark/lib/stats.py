"""Percentiles and spreads, one definition for every reader and test."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of every value: the
    smallest value with at least q % of the values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    s = sorted(values)
    return s[max(math.ceil(q / 100.0 * len(s)) - 1, 0)]


def spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median, by statistics.quantiles(n=4)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
