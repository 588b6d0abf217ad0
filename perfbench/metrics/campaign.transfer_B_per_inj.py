"""Host<->device bytes (``CampaignResult.transfer``, up + down) an
injection."""


def read(ctx):
    if ctx.injections <= 0 or not ctx.transfer:
        return None
    return (ctx.transfer.get("up", 0) + ctx.transfer.get("down", 0)) \
        / ctx.injections
