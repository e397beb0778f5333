"""Window statistics."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile by nearest rank: the smallest sample with at
    least q % of all samples at or below it."""
    s = sorted(values)
    if not s:
        raise ValueError("no samples")
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


def spread(values) -> float:
    """Distance between the first and third quartile as a share of the
    median (`statistics.quantiles(values, n=4)`)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
