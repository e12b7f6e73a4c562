"""particle_steps_per_s: N particles times T steps times the queries
completed, over the whole window's seconds (host clock)."""

from harness import stats


def read(ctx):
    return stats.rate(ctx.n * ctx.T, len(ctx.queries), ctx.window_s)
