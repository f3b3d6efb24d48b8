"""The benchmark's own statistics: nearest-rank percentiles and the window's
rate."""

from __future__ import annotations

import math
from typing import Sequence


def nearest_rank(values: Sequence[float], pct: float) -> float:
    """The smallest value with at least pct% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(pct / 100.0 * len(ordered)))
    return ordered[rank - 1]


def window_rate(units: Sequence[float], window_s: float) -> float:
    """Work completed in the window over the window's whole length: stalls,
    gaps between requests and the host's own time all count."""
    if window_s <= 0:
        raise ValueError(f"window of {window_s} s")
    return sum(units) / window_s
