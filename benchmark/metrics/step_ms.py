"""step_ms: wall ms per training step, the whole window over the steps
completed in it (host clock; each step ends in a host read of its loss)."""


def read(ctx):
    w = ctx.window
    return w["seconds"] * 1e3 / w["steps"] if w.get("steps") else None
