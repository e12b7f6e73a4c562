"""glue_launches_per_query (chunk glue and launcher): the traced slice's
kernel and graph launch calls that start inside one of the port's
``smc.run`` spans and inside no ``launch.*`` span (PyTorch's own
kernels), over its queries.  With the ``launch.*`` spans a query, and
the calls outside every ``smc.run`` (none in a closed loop so far), it
makes ``launches_per_query``."""

from harness import spans


def read(ctx):
    return spans.per_query(ctx, lambda s: s.unmarked_launches(ctx.trace.launches))
