"""setup_s: seconds from the start of the process to the opening of the
window: imports, the card, the kernel libraries (built on a checkout's
first run), the pool of series and the warm-up queries."""


def read(ctx):
    return ctx.setup_s
