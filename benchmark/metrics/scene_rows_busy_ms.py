"""scene_rows_busy_ms: device ms a step of the work that starts inside the
program's `scene.rows` range: every visible model's rows activated and
concatenated into the render's inputs (`concat_states`, and a shard's pad),
from the traced steps. A program without the range reads nothing."""

RANGES = ("scene.rows",)


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    s = tr.in_ranges(RANGES)
    return None if s is None else s * 1e3 / tr.n_steps
