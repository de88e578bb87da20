"""render_bwd_busy_ms: device ms a step of the work that starts inside the
program's `fps.render.bwd` range: the rasterizer's backward (K2, the
gradient table's gathers and blocked cumsum, the projection and SH
backward over every row), from the gradients of the render's outputs to
those of its inputs, on autograd's thread; from the traced steps."""

RANGES = ("fps.render.bwd",)


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    s = tr.in_ranges(RANGES)
    return None if s is None else s * 1e3 / tr.n_steps
