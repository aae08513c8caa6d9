"""The benchmark's arithmetic: percentiles, rates and spreads of step records."""

from __future__ import annotations

import math
import statistics
from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q`` quantile (0..1) of ``values`` by linear interpolation
    between the closest ranks, as numpy's default; None when empty."""
    if not values:
        return None
    ordered = sorted(values)
    pos = q * (len(ordered) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(ordered) - 1)
    return ordered[lo] + (ordered[hi] - ordered[lo]) * (pos - lo)


def rate(count: int, seconds: float) -> Optional[float]:
    """``count`` over ``seconds``; None for an empty window."""
    return count / seconds if seconds > 0 else None


def mean(values: Sequence[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None


def spread(values: Sequence[float]) -> float:
    """The distance between the first and the third quartile of
    ``values`` (``statistics.quantiles(values, n=4)``), as a share of
    their median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)

