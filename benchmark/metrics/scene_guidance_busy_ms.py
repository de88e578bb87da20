"""scene_guidance_busy_ms: device ms a step of the work that starts inside the
program's `scene.vae_encode` and `scene.ladder` ranges (the VAE encode, the
UNet ladder and the CSD gradient; the UNet passes replayed from CUDA graphs
included, their kernels correlating with the graph launch inside
`scene.ladder`), from the traced steps."""

RANGES = ("scene.vae_encode", "scene.ladder")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    s = tr.in_ranges(RANGES)
    return None if s is None else s * 1e3 / tr.n_steps
