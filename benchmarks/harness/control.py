"""The control of the correctness check: the plain reference put in the
program's place and computed in bfloat16, the precision below the
float32 the configurations state.  Its answers for the queries of a run
(the log-evidence of each query's series, the filtering distribution of
each summarized one) go through the same numbers and limits as the
program's; the check has to call them not correct."""

from __future__ import annotations

from . import check
from .traffic import Plan


def control(cell, seed: int, queries: int, dtype, device="cpu") -> tuple:
    """``(correct, checks)`` of the reference in ``dtype`` answering the
    first ``queries`` queries of a run seeded ``seed``."""
    plan = Plan(cell.traffic, cell.config, cell.reference, seed)
    exact_logz, exact_filter = cell.reference.exact(plan.pool, cell.config)
    low_logz, low_filter = cell.reference.recursion(plan.pool, cell.config, dtype, device)
    series = [plan.series(q) for q in range(queries)]
    errors = low_logz[series] - exact_logz[series]
    filter_errors = [cell.reference.filter_error(low_filter[plan.series(q)],
                                                 exact_filter[plan.series(q)])
                     for q in range(queries) if plan.sampled(q)]
    values = check.numbers(plan.n, errors, filter_errors)
    return check.judge(values, cell.limits, failed=0)
