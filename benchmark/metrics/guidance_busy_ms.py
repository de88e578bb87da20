"""guidance_busy_ms: device ms a step of the work that starts inside the
program's `fps.vae_encode` and `fps.ladder` ranges (the VAE encode, the UNet
ladder and the CSD gradient), from the traced steps."""

RANGES = ("fps.vae_encode", "fps.ladder")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    s = tr.in_ranges(RANGES)
    return None if s is None else s * 1e3 / tr.n_steps
