"""chunk_kernel_roofline (kernels): the frozen bound of the chunk
kernel's launches a query (published peaks, the cell's shapes and steps a
launch), over the kernel's device time a query in the traced slice, in
%.  The per-step cells launch it for one step."""


def read(ctx):
    system = ctx.cell.system
    if ctx.trace is None:
        return None
    s = ctx.trace.kernel_s(system.CHUNK_KERNEL)
    if s <= 0:
        return None
    bounds = system.chunk_launch_bounds(ctx.cell.config, ctx.cell.traffic, ctx.n,
                                        ctx.plan.steps_per_launch())
    bound_ms = sum(b["bound_ms"] for b in bounds)
    return 100.0 * bound_ms / (s * 1e3 / ctx.traced_queries)
