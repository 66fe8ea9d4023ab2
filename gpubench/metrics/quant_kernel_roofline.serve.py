"""The bytes bound of the window's quantized lookups
(`work.quant_lookup_bytes`: packed distinct rows with their scale and
shift, ids, lengths, outputs: what Kq itself reads and writes) over the
card's memory rate, as a share of the device time under the program's
`## lookup_kernel ##` span (Kq alone, without its input route), in %."""


def read(ctx):
    r = ctx.reduced
    if r is None or ctx.peaks is None:
        return None
    s = r.device_s("## lookup_kernel ##")
    if s <= 0:
        return None
    return 100.0 * ctx.bytes["quant_lookup"] / ctx.peaks["hbm_bytes_per_s"] / s
