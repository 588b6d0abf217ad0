"""Injections classified in the window over the window's wall seconds,
from the first campaign's start to the last record on the host."""


def read(ctx):
    if ctx.window_s <= 0:
        return None
    return ctx.injections / ctx.window_s
