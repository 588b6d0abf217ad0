"""Share of the traced window in which the card was idle and the host was
in none of the program's top-level spans (``trace.OUTSIDE``): idle time
that no stage of the campaign runner accounts for."""

from perfbench import trace


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * ctx.trace.idle_by_stage.get(trace.OUTSIDE, 0.0) \
        / ctx.trace.window_s
