"""Examples stepped in the window over the window's wall time (host
clock, from the window's start to after its final synchronise)."""


def read(ctx):
    return ctx.work / ctx.window_s
