"""Device milliseconds a step under the sharded EBC's glue spans, outside
its groups' own: `## ebc_output ##` (the concatenation of the groups'
pooled values into the KeyedTensor) and `## ebc_cotangent ##` (the stack
of each group's cotangent slices before its update)."""

from gpubench.spans import device_ms_per_call


def read(ctx):
    return device_ms_per_call(ctx, "## ebc_output ##", "## ebc_cotangent ##")
