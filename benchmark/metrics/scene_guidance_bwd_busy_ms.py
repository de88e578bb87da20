"""scene_guidance_bwd_busy_ms: device ms a step of the work that starts inside
the program's `scene.vae_encode.bwd` range: the VAE encoder's backward in
the scene step, from the gradient of the latents to that of the encoder's
input, on autograd's thread; from the traced steps."""

RANGES = ("scene.vae_encode.bwd",)


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    s = tr.in_ranges(RANGES)
    return None if s is None else s * 1e3 / tr.n_steps
