"""Device milliseconds a batch of the elementwise and indexing kernels
(every kernel that is not K1, K2, the product or a copy; the frozen
grouping of ``perfbench/kernels.py``)."""

from perfbench import kernels


def read(ctx):
    if ctx.trace is None or ctx.batches <= 0:
        return None
    seconds = ctx.trace.layer_s(kernels.ELEMENTWISE)
    return 1000.0 * seconds / ctx.batches if seconds > 0 else None
