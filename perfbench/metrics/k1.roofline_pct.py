"""K1's share of its bandwidth bound: the bytes the reference's sync plan
makes K1's (``perfbench/roofline.py``) over 3.35 TB/s, over K1's device
time in the traced window."""

from perfbench import kernels, roofline


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline.share_pct(ctx.vote_bytes.get(kernels.K1, 0),
                              ctx.trace.layer_s(kernels.K1))
