"""What the per-layer metrics of the program's layer spans share: device
time under spans, per call of the timed entry (a train step, or a scoring
chunk). The spans are the program's (torchrec_tpu_torch/utils/tracing.py);
a program without them gives no reading, and the metric is left out."""


def device_ms_per_call(ctx, *prefixes: str):
    """Device milliseconds a call of the operations launched under any span
    whose name starts with one of `prefixes` (each operation once), or
    None where the run was not traced or no such span held a launch."""
    r = ctx.reduced
    if r is None or not ctx.attempted:
        return None
    s = r.device_s(*prefixes)
    return s / ctx.attempted * 1e3 if s > 0 else None
