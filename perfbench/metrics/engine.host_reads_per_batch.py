"""Blocking device-to-host reads a batch (``CampaignResult.transfer``'s
``reads``): the engine's fire-plan copy and halt reads, and the collect's
copies.  A program that does not count them reports nothing."""


def read(ctx):
    if ctx.batches <= 0 or "reads" not in ctx.transfer:
        return None
    return ctx.transfer["reads"] / ctx.batches
