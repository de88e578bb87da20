"""k1_roofline: the share of its roofline that K1 (csrc/composite_fwd.cu: its tile-order
kernel and the compositing kernel) reaches on the cell's view."""

from benchmark.metrics.common import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "k1", ("composite_fwd_kernel", "tile_order_kernel"))
