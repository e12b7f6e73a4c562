"""The correctness check: what the timed queries answered against the
plain reference, each number beside its limit.

The numbers, each scaled by the population N so that it reads the same at
any population size (the estimator's variance falls as 1/N):

- ``logz_medsq_n``: N times the median over every query of the window of
  (log Z-hat - log Z)^2, log Z by the reference's exact recursion.  Steady
  from seed to seed, so its limit sits close: a run that does the
  statistical work of half the particles it states, or whose estimates
  carry a bias of their own size, reads high;
- ``logz_mse_n``: N times the mean of the same squares, tails included;
- ``logz_gap_rootn``: sqrt(N) times the widest |log Z-hat - log Z| of any
  query: one wrong answer;
- ``filter_medsq_n``: N times the median over the summarized queries of the
  final population's squared distance from the exact filtering
  distribution (the reference's ``filter_error``);
- ``failed``: queries whose estimate is not a finite number (limit 0).

A cell compares the numbers its limits file names.
"""

from __future__ import annotations

import math

import numpy as np

NUMBERS = ("logz_medsq_n", "logz_mse_n", "logz_gap_rootn", "filter_medsq_n")


def numbers(n: int, logz_errors, filter_errors) -> dict:
    e2 = np.square(np.asarray(logz_errors, np.float64))
    f = np.asarray(filter_errors, np.float64)
    nan = math.nan
    return {
        "logz_medsq_n": float(n * np.median(e2)) if e2.size else nan,
        "logz_mse_n": float(n * np.mean(e2)) if e2.size else nan,
        "logz_gap_rootn": float(math.sqrt(n * np.max(e2))) if e2.size else nan,
        "filter_medsq_n": float(n * np.median(f)) if f.size else nan,
    }


def judge(values: dict, limits: dict, failed: int) -> tuple:
    """``(correct, checks)``: every number the limits name finite and at
    most its limit, and no query failed; ``checks`` maps each to its value
    and limit."""
    unknown = set(limits) - set(NUMBERS)
    if unknown:
        raise KeyError(f"limits name no number of the check: {sorted(unknown)}")
    checks = {name: {"value": values[name], "limit": float(limits[name])}
              for name in NUMBERS if name in limits}
    checks["failed"] = {"value": int(failed), "limit": 0}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    return correct, checks


def lines(checks: dict) -> list:
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r})"
            for name, c in checks.items()]
