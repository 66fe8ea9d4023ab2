"""Device milliseconds a step under the program's interaction spans,
forward and backward (`.bwd`): the DLRM's `## dlrm_interaction ##` (the
Gram product and its upper-triangle gather), the DeepFM's
`## deepfm_fm ##` (the FM with its concatenation of 27 inputs)."""

from gpubench.spans import device_ms_per_call


def read(ctx):
    return device_ms_per_call(ctx, "## dlrm_interaction", "## deepfm_fm")
