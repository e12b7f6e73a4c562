"""ms_to_1e-3_nat: card time to an RMS error of 1e-3 nats in log Z: the
window's ms a query times the mean square error of the window's queries
against the exact log-evidence, over (1e-3)^2.  Variance and bias count
together, so a faster sweep that loses statistical efficiency is not
faster here."""

from harness import stats


def read(ctx):
    mse = stats.mean_square(ctx.logz_errors)
    return stats.ms_to_accuracy(ctx.window_s, len(ctx.queries), mse, 1e-3)
