"""glue_host_ms (chunk glue and launcher): host ms inside the port's
``smc.run`` spans covered by no ``launch.*`` and no ``resample.epoch``
span (PyTorch's glue and the sweep's Python) in the traced slice, over
its queries.  With ``launch_host_ms`` and ``epoch_host_ms`` it sums to
the mean ``smc.run``.

On the profiler's clock: every operator and span inside carries the
profiler's own cost (about 10 us an operator and 11.5 us a span on an
H100 host), so it reads above the untraced host time;
``host_enqueue_ms`` is the untraced whole."""

from harness import spans


def read(ctx):
    return spans.per_query(ctx, lambda s: s.glue_ms())
