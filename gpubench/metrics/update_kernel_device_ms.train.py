"""Device milliseconds a step under `## update_kernel ##`: the fused
update's kernels alone (K4 for rowwise Adagrad, K7 for Adam)."""

from gpubench.spans import device_ms_per_call


def read(ctx):
    return device_ms_per_call(ctx, "## update_kernel ##")
