"""The 95th percentile (nearest rank) of the window's chunk latencies,
each from its issue to its scores on the host; a chunk that never
completed counts as the slowest. The scoring loop is closed, with a
fixed number of chunks in flight, so the chunk rate sets this tail: it
is read beside the rate, in the traced run, and bound by none."""

import math


def read(ctx):
    if not ctx.attempted:
        return None
    lat = sorted(ctx.latencies_s) + [math.inf] * ctx.failed
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
