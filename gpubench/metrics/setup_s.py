"""Seconds from the process's start to the window's start: imports,
kernel builds or loads, weights and inputs made from the seed, the
checked and warm-up steps."""


def read(ctx):
    return ctx.setup_s
