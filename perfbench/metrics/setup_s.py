"""Seconds from the process's start to the window's: imports, the card's
context, the kernels' build, the program's build, the schedules' draw
and one warm campaign."""


def read(ctx):
    return ctx.setup_s
