"""k4_fwd_busy_ms: device ms a step of K4's forward kernels (every device
event whose name holds `flash_fwd`: `flash_fwd_wgmma_kernel`,
`flash_fwd_tc_split_kernel`, `flash_fwd_kernel`), from the traced steps. It
reads kernels by name, so it counts the UNet passes that the program
replays from CUDA graphs, inside which no profiler range opens. A trace
without such a kernel reads nothing."""

PATTERN = "flash_fwd"


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    k = tr.kernels(PATTERN)
    return sum(e - s for s, e in k) / 1e3 / tr.n_steps if k else None
