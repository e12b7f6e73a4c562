"""launch_host_ms (chunk glue and launcher): host ms inside the port's
``launch.<kernel>`` spans (a ctypes launch with its argument checks and
output allocations) in the traced slice's ``smc.run`` spans, over its
queries.

On the profiler's clock: every operator and span inside carries the
profiler's own cost (about 10 us an operator and 11.5 us a span on an
H100 host), so it reads above the untraced host time;
``host_enqueue_ms`` is the untraced whole."""

from harness import spans


def read(ctx):
    return spans.per_query(ctx, lambda s: s.launch_ms())
