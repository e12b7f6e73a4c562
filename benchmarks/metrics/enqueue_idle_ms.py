"""enqueue_idle_ms (sweep driver): ms inside the port's ``smc.run`` spans
in which no operation ran on the card (the card waiting on the query's
own enqueue), in the traced slice, over its queries.  The profiler's
own cost on the host (about 10 us an operator, 11.5 us a span on an H100
host) lengthens the enqueue, and with it this idle time and the slice's
``device_idle_share``, above an untraced query's."""

from harness import spans


def read(ctx):
    return spans.per_query(ctx, lambda s: s.idle_in_runs_ms(ctx.trace.device))
