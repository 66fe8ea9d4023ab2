"""Device milliseconds a step of the operations launched under the
program's `## train_dense_forward ##` and `## train_backward ##` spans
(the dense model, the interaction, the loss and their backward)."""


def read(ctx):
    r = ctx.reduced
    if r is None or not ctx.attempted:
        return None
    s = r.device_s("## train_dense_forward ##", "## train_backward ##")
    return s / ctx.attempted * 1e3 if s > 0 else None
