"""host_enqueue_ms (sweep driver): mean host time from the call to
``run`` until it returns, before log Z-hat is read, over the queries a
traced run makes after its traced slice."""


def read(ctx):
    qs = ctx.steady
    return sum((q.t1 - q.t0) for q in qs) * 1e3 / len(qs) if qs else None
