"""The bytes bound of the window's fused sparse optimizer steps
(`work.update_bytes`: distinct rows and their state read and written
once, the pooled cotangent, ids and lengths read once) over the card's
memory rate, as a share of the device time under every
`## ebc_update_* ##` span (sort, segment sums and kernels alike), in %."""


def read(ctx):
    r = ctx.reduced
    if r is None or ctx.peaks is None:
        return None
    s = r.device_s("## ebc_update_")
    if s <= 0:
        return None
    return 100.0 * ctx.bytes["update"] / ctx.peaks["hbm_bytes_per_s"] / s
