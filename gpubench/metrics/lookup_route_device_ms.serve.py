"""Device milliseconds a chunk under `## lookup_route ##`: the quantized
lookup's input route before Kq (each slot's ids in int32 offset to its
table, lengths, coefficients and mean denominators)."""

from gpubench.spans import device_ms_per_call


def read(ctx):
    return device_ms_per_call(ctx, "## lookup_route ##")
