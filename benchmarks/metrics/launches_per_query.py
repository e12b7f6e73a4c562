"""launches_per_query (chunk glue and launcher): the host's kernel and
graph launch calls in the traced slice, over its queries."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.launches:
        return None
    return len(ctx.trace.launches) / ctx.traced_queries
