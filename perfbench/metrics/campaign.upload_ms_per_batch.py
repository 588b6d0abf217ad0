"""Host milliseconds a batch copying fault columns to the card: the
resident schedule's upload (``sparse_setup/setup.upload``) and the dense
path's per-batch one (``dispatch/engine.upload``), from
``CampaignResult.stages``.  A program without nested spans reports
nothing."""

UPLOADS = ("sparse_setup/setup.upload", "dispatch/engine.upload")


def read(ctx):
    if ctx.batches <= 0 or not any("/" in k for k in ctx.stages):
        return None
    return 1000.0 * sum(ctx.stages.get(k, 0.0) for k in UPLOADS) \
        / ctx.batches
