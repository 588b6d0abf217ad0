"""Host milliseconds a batch inside the region's own step call: the
engine's ``step.region`` span, nested in ``dispatch``
(``dispatch/step.region`` in ``CampaignResult.stages``).  A program that
records no such span reports nothing."""

SPAN = "dispatch/step.region"


def read(ctx):
    if ctx.batches <= 0 or SPAN not in ctx.stages:
        return None
    return 1000.0 * ctx.stages[SPAN] / ctx.batches
