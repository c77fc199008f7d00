"""The arithmetic that turns a run's records into numbers.

A rate is taken over all the work and all the time of the window; a tail
over every request completed in it; the device's busy time is the union
of its event intervals (a collective's stream may overlap the compute
stream, so intervals are merged, not summed).
"""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def rate(work: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least q% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def busy(intervals: Iterable[Tuple[float, float]]) -> float:
    return sum(end - start for start, end in merged(intervals))


def idle_pct(busy_s: float, window_s: float) -> float:
    return 100.0 * (1.0 - busy_s / window_s)


def roofline_pct(least_s: float, device_s: float) -> float:
    """The least time the chip could take for the work over the time its
    kernels took; above 100 the work is counted too high or the time too
    low, and it is reported as it is."""
    return 100.0 * least_s / device_s


def rel_rmse(got, want) -> float:
    """sqrt(mean((got - want)^2)) / sqrt(mean(want^2)) over all elements."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2) / max(np.mean(want ** 2), 1e-300)))
