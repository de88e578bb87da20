"""attention_busy_ms: device ms a step of the work that starts inside the
program's `sd.attention` ranges (the SD attention cores of the UNet ladder
and the VAE, from the scores or the K4 call to the P.V output; their
projections outside), from the traced steps. A program without the range
reads nothing."""

RANGES = ("sd.attention",)


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    s = tr.in_ranges(RANGES)
    return None if s is None else s * 1e3 / tr.n_steps
