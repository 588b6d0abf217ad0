"""Host milliseconds a batch spent issuing the engine's work: the
``dispatch`` stage less its nested spans that wait on a copy
(``dispatch/engine.upload``, ``dispatch/engine.fire_read`` and
``dispatch/engine.halt_read`` in ``CampaignResult.stages``).  A program
without nested spans reports nothing."""

WAITS = ("dispatch/engine.upload", "dispatch/engine.fire_read",
         "dispatch/engine.halt_read")


def read(ctx):
    if ctx.batches <= 0 or "dispatch" not in ctx.stages \
            or not any("/" in k for k in ctx.stages):
        return None
    waits = sum(ctx.stages.get(k, 0.0) for k in WAITS)
    return 1000.0 * (ctx.stages["dispatch"] - waits) / ctx.batches
