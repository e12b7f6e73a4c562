"""epoch_roofline (resample epoch): the frozen byte bound of the traced
queries' resample epochs (the configuration's ``epoch_launch_bounds``: per
resample a query performed, its ``resampled`` flags, the weights read once
and each particle's state read once and written once) over the device ms
of the epoch's kernels (``lse_stats_kernel``, ``pass1_scan_kernel``,
``pass2_tile_kernel`` and its row form) in the traced slice, in %."""

EPOCH_KERNELS = ("lse_stats_kernel", "pass1_scan_kernel", "pass2_tile_kernel")


def read(ctx):
    system = ctx.cell.system
    if ctx.trace is None or not hasattr(system, "epoch_launch_bounds"):
        return None
    s = ctx.trace.kernel_s(*EPOCH_KERNELS)
    traced = ctx.queries[:ctx.traced_queries]
    if s <= 0 or not traced or any(q.flags is None for q in traced):
        return None
    bound_ms = sum(b["bound_ms"] for q in traced
                   for b in system.epoch_launch_bounds(ctx.cell.config, ctx.cell.traffic,
                                                       ctx.n, q.flags))
    return 100.0 * bound_ms / (s * 1e3) if bound_ms > 0 else None
