"""Arithmetic that several metric readers share."""

from benchmark import peaks
from benchmark.counts import raster as CR


def idle_pct(ctx):
    """100 x (1 - device busy a step / wall time a step): busy is the union
    of the device's kernel, copy and set intervals over the traced steps
    (overlapping kernels count once), the wall time the untraced window's
    mean step (the profiler slows the host, so the traced steps' own wall
    time would overstate the idle share)."""
    tr, w = ctx.trace, ctx.window
    if tr is None or not tr.busy or not w.get("steps"):
        return None
    return 100.0 * (1.0 - (tr.busy_s / tr.n_steps) / (w["seconds"] / w["steps"]))


def roofline_pct(ctx, which: str, patterns):
    """The least time one H100 could take for the view's counted work of
    kernel `which` (counts/raster.py, float32 peak or HBM), over the mean
    device time a launch took in the traced steps, in %. A launch's time is
    the summed time of the device kernels whose names hold one of
    `patterns`, over the launches of the first."""
    tr = ctx.trace
    if tr is None or not hasattr(ctx.run, "view_counts"):
        return None
    launches = len(tr.kernels(patterns[0]))
    if not launches:
        return None
    dev_s = sum(e - s for p in patterns for s, e in tr.kernels(p)) / 1e6
    c = ctx.run.view_counts()
    work = getattr(CR, which)(c["live"], c["pairs"], c["live_chunks"], c["n_tiles"],
                              c["tile_pix"])
    least_ms, _ = peaks.least_ms(work["ops"], work["bytes"])
    return 100.0 * least_ms / (dev_s * 1e3 / launches)
