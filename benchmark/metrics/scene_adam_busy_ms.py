"""scene_adam_busy_ms: device ms a step of the work that starts inside the
program's `scene.adam` range: the masked Adam update of every row of the
trained models and their densification statistics (max radii, gradient
accumulator), from the traced steps."""

RANGES = ("scene.adam",)


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    s = tr.in_ranges(RANGES)
    return None if s is None else s * 1e3 / tr.n_steps
