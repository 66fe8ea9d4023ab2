"""Device milliseconds a step under `## lookup_kernel ##`: the pooled
lookup's kernel alone (K1), without its route (ids, mask, coefficients)."""

from gpubench.spans import device_ms_per_call


def read(ctx):
    return device_ms_per_call(ctx, "## lookup_kernel ##")
