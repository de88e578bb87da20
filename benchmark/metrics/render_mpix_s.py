"""render_mpix_s: pixels rendered forward + backward per second, all the
pixels of the window over all its time (host clock, one synchronize at the
window's end)."""


def read(ctx):
    w = ctx.window
    if "pixels_per_step" not in w:
        return None
    return w["steps"] * w["pixels_per_step"] / w["seconds"] / 1e6
