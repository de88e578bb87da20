"""peak_mem_gib: torch.cuda.max_memory_allocated() from the end of set-up to
the end of the window, GiB."""


def read(ctx):
    return ctx.peak_window_bytes / 2**30 if ctx.peak_window_bytes else None
