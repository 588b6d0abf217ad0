"""Host milliseconds a batch issuing the commit sync point's votes and
repairs: the engine's ``engine.commit`` span (the fused engine's K2
commit and any K1 sites, the unfused engine's K1), nested in ``dispatch``
(``dispatch/engine.commit`` in ``CampaignResult.stages``).  A program
that records no such span reports nothing."""

SPAN = "dispatch/engine.commit"


def read(ctx):
    if ctx.batches <= 0 or SPAN not in ctx.stages:
        return None
    return 1000.0 * ctx.stages[SPAN] / ctx.batches
