"""scene_render_bwd_busy_ms: device ms a step of the work that starts inside
the program's `scene.render.bwd` range: the rasterizer's backward (K2, the
gradient table's gathers, the projection and SH backward over every row)
and the activation's, from the gradients of the render's outputs to those
of the models' rows, on autograd's thread; from the traced steps."""

RANGES = ("scene.render.bwd",)


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    s = tr.in_ranges(RANGES)
    return None if s is None else s * 1e3 / tr.n_steps
