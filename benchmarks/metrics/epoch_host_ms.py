"""epoch_host_ms (resample epoch): host ms inside the port's
``resample.epoch`` spans less their ``launch.*`` children (the epoch's
own PyTorch calls and Python) in the traced slice, over its queries.

On the profiler's clock: every operator and span inside carries the
profiler's own cost (about 10 us an operator and 11.5 us a span on an
H100 host), so it reads above the untraced host time;
``host_enqueue_ms`` is the untraced whole."""

from harness import spans


def read(ctx):
    return spans.per_query(ctx, lambda s: s.epoch_self_ms() if s.epochs else None)
