"""setup_s: seconds from process start to the first timed step (host clock):
building or loading the kernels, making weights and scenes, warming up."""


def read(ctx):
    return ctx.setup_s
