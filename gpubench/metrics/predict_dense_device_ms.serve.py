"""Device milliseconds a chunk under the dense model's spans in the
predict call: `## dlrm_* ##` (dense arch, interaction, over arch) or
`## deepfm_* ##`."""

from gpubench.spans import device_ms_per_call


def read(ctx):
    return device_ms_per_call(ctx, "## dlrm_", "## deepfm_")
