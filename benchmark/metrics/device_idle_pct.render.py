"""device_idle_pct: the share of a step's wall time in which no kernel, copy
or set ran on the card: the traced steps' device busy time a step
(torch.profiler; overlapping kernels count once) against the untraced
window's mean step."""

from benchmark.metrics.common import idle_pct


def read(ctx):
    return idle_pct(ctx)
