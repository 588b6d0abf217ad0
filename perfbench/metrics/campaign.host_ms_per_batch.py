"""Host milliseconds a batch in the campaign runner's own stages
(``CampaignResult.stages``): schedule, pad, sparse_setup and classify, the
stages that do not wait on the card."""

HOST_STAGES = ("schedule", "pad", "sparse_setup", "classify")


def read(ctx):
    if ctx.batches <= 0:
        return None
    host_s = sum(ctx.stages.get(k, 0.0) for k in HOST_STAGES)
    return 1000.0 * host_s / ctx.batches
