"""query_ms_p95: the 95th percentile of the latency of every query of the
window, from the call to ``run`` until log Z-hat is on the host (host
clock)."""

from harness import stats


def read(ctx):
    return stats.percentile([q.ms for q in ctx.queries], 95)
