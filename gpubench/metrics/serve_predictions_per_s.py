"""Candidates whose scores reached the host in the window, over the time
from the window's start to the last of them (host clock)."""


def read(ctx):
    return ctx.work / ctx.window_s
