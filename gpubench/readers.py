"""Readers that several per-layer metrics share: the metric files of one
quantity in different cells (`<name>.train`, `<name>.serve`) each bind
one of these as their `read`."""


def dispatch_ms(ctx):
    """Mean host milliseconds inside each call of the timed entry (the
    train step, or the predict module's predict) over the traced window.
    Where the device is behind, a call waits inside for room in the
    launch queue."""
    if ctx.reduced is None or not ctx.host_s:
        return None
    return sum(ctx.host_s) / len(ctx.host_s) * 1e3


def idle_share(ctx):
    """Share of the traced window in which no device operation ran (the
    union of kernel, memcpy and memset intervals), in %."""
    r = ctx.reduced
    if r is None or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)


def mfu(ctx):
    """The model's operations in the traced window (`flops_per_item`, from
    the reference's shapes, times the items done) over its length, as a
    share of the card's peak in the configuration's dtype, in %."""
    if ctx.reduced is None or ctx.peaks is None or ctx.window_s <= 0:
        return None
    rate = ctx.flops_per_item * ctx.work / ctx.window_s
    return 100.0 * rate / ctx.peaks[ctx.dtype]
