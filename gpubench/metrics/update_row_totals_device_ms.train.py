"""Device milliseconds a step under `## update_row_totals ##`: the fused
update's sort of the slots by row and the segment sums that total each
row's gradient (`dedup_row_grads`, `run_total_row_grads`)."""

from gpubench.spans import device_ms_per_call


def read(ctx):
    return device_ms_per_call(ctx, "## update_row_totals ##")
