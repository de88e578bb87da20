"""k2_roofline: the share of its roofline that K2
(csrc/composite_bwd.cu) reaches on the cell's view."""

from benchmark.metrics.common import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "k2", ("composite_bwd_kernel",))
