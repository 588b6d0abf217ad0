"""Device milliseconds a batch of the product's cuBLAS kernels."""

from perfbench import kernels


def read(ctx):
    if ctx.trace is None or ctx.batches <= 0:
        return None
    seconds = ctx.trace.layer_s(kernels.GEMM)
    return 1000.0 * seconds / ctx.batches if seconds > 0 else None
