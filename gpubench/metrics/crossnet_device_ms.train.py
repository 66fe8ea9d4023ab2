"""Device milliseconds a step under the program's cross-net spans,
forward and backward (`.bwd`): DLRM_DCN's `## dlrm_crossnet ##`, the
concatenation of x0 and the low-rank cross net."""

from gpubench.spans import device_ms_per_call


def read(ctx):
    return device_ms_per_call(ctx, "## dlrm_crossnet")
