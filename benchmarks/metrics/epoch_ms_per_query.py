"""epoch_ms_per_query (resample epoch): device ms of the streaming
epoch's kernels (``lse_stats_kernel``, ``pass1_scan_kernel``,
``pass2_tile_kernel``) in the traced slice, over its queries."""

EPOCH_KERNELS = ("lse_stats_kernel", "pass1_scan_kernel", "pass2_tile_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.kernel_s(*EPOCH_KERNELS)
    return s * 1e3 / ctx.traced_queries if s > 0 else None
