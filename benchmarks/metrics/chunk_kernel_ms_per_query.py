"""chunk_kernel_ms_per_query (kernels): device ms of the configuration's
chunk kernel (``CHUNK_KERNEL``) in the traced slice, over its queries:
the kernel's absolute cost beside its share of the bound
(``chunk_kernel_roofline``)."""


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.kernel_s(ctx.cell.system.CHUNK_KERNEL)
    return s * 1e3 / ctx.traced_queries if s > 0 else None
