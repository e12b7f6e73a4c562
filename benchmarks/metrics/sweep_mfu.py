"""sweep_mfu (whole sweep): the bound of the work each query needs
(``harness.yardstick.sweep_bound``: its draws and reweights, the
population written and read once, once more for each resample it
performed) over the host-clock ms the query took, in %, over the queries
a traced run makes after its traced slice."""

from harness import yardstick


def read(ctx):
    qs = ctx.steady
    if not qs or any(q.flags is None for q in qs):
        return None
    work = ctx.cell.system.step_work(ctx.cell.config)
    bound_ms = sum(yardstick.sweep_bound(ctx.n, work, q.flags)["bound_ms"] for q in qs)
    return 100.0 * bound_ms / sum(q.ms for q in qs)
