"""scene_render_busy_ms: device ms a step of the work that starts inside the
program's `scene.render` range (the models' rows concatenated and
activated, `scene.rows`, then projection, SH, binning, K3 and K1 over the
step's cameras), from the traced steps."""

RANGES = ("scene.render",)


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    s = tr.in_ranges(RANGES)
    return None if s is None else s * 1e3 / tr.n_steps
