"""The arithmetic the benchmark's numbers rest on, on plain sequences so
that tests can hold it to fixed inputs."""

from __future__ import annotations

import math
from typing import Iterable, Sequence


def percentile(values: Sequence[float], pct: float) -> float:
    """The ``pct`` percentile of ``values``, linear between the order
    statistics (rank ``pct / 100 * (n - 1)``, NumPy's default)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("no values")
    rank = pct / 100.0 * (len(xs) - 1)
    lo = math.floor(rank)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (rank - lo)


def mean_square(errors: Iterable[float]) -> float:
    """The mean of the squared errors."""
    xs = [float(e) for e in errors]
    return sum(e * e for e in xs) / len(xs)


def rate(work_per_query: float, queries: int, seconds: float) -> float:
    """Work over the whole window: ``work_per_query`` times the queries
    completed, over the window's seconds."""
    return work_per_query * queries / seconds


def ms_to_accuracy(window_s: float, queries: int, mse: float, target: float) -> float:
    """Card time to an RMS error of ``target``: the ms a query took over
    the window, times the queries needed to bring the mean square error
    ``mse`` of one query down to ``target`` squared."""
    return window_s * 1e3 / queries * mse / (target * target)


def union_length(intervals: Iterable[tuple], lo: float, hi: float) -> float:
    """Length of the union of the ``(start, end)`` intervals clipped to
    ``[lo, hi]``."""
    busy, reach = 0.0, lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    return busy


def gaps(intervals: Iterable[tuple], lo: float, hi: float) -> list:
    """The ``(start, end)`` stretches of ``[lo, hi]`` that no interval
    covers, in order."""
    out, reach = [], lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if a > reach:
            out.append((reach, a))
        reach = max(reach, b)
    if hi > reach:
        out.append((reach, hi))
    return out
