"""Order statistics the metric readers share."""

from __future__ import annotations

import math
import statistics


def nearest_rank(values, q: float) -> float:
    """The ``q`` quantile (0 < q <= 1) by nearest rank: a value that was
    read, and inf when the rank falls on a failed (inf) entry."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def median(values):
    return statistics.median(values) if values else None
