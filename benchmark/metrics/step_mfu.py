"""step_mfu: the step's model FLOPs (the UNet passes its ladders call for and
the VAE encoder's forward and backward, counts/sd.py) over the window's time
at the H100's dense bf16 peak, in %. The step time is the window's, taken
before the profiler starts."""

from benchmark import peaks


def read(ctx):
    w = ctx.window
    if ctx.trace is None or "rungs" not in w:
        return None
    return 100.0 * ctx.run.step_flops(w["rungs"]) / w["seconds"] / peaks.BF16_FLOPS
