"""The bytes bound of the window's pooled lookups (`work.lookup_bytes`:
distinct rows, ids, lengths, outputs) over the card's memory rate, as a
share of the device time under every `## ebc_fwd_* ##` span, in %."""


def read(ctx):
    r = ctx.reduced
    if r is None or ctx.peaks is None:
        return None
    s = r.device_s("## ebc_fwd_")
    if s <= 0:
        return None
    return 100.0 * ctx.bytes["lookup"] / ctx.peaks["hbm_bytes_per_s"] / s
