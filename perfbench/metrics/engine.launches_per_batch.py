"""CUDA kernel launches in the traced window (memory copies and fills of
the runtime left out) a batch."""


def read(ctx):
    if ctx.trace is None or ctx.batches <= 0 or ctx.trace.launches <= 0:
        return None
    return ctx.trace.launches / ctx.batches
