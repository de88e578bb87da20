"""raster_mfu: the render step's counted rasterizer work (projection and SH
forward and backward, K1 and K2 over the view's pairs; counts/raster.py),
each at the H100's peak of its precision (all float32), over the window's
mean step time, in %."""

from benchmark import peaks
from benchmark.counts import raster as CR


def read(ctx):
    if ctx.trace is None or not hasattr(ctx.run, "view_counts"):
        return None
    c = ctx.run.view_counts()
    args = (c["live"], c["pairs"], c["live_chunks"], c["n_tiles"], c["tile_pix"])
    ops = (CR.k1(*args)["ops"] + CR.k2(*args)["ops"]
           + CR.splat_ops(c["visible"], c["sh_degree"])["ops"])
    w = ctx.window
    step_s = w["seconds"] / w["steps"]
    return 100.0 * ops / peaks.FP32_FLOPS / step_s
