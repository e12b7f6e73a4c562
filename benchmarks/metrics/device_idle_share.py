"""device_idle_share (device): the share of the traced slice, from its
first synced point to its last query's read, in which no operation ran on
the card, in %."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s())
