"""unet_graph_pct: the UNet passes the process replayed from a CUDA graph
over every UNet pass it ran on the card, in %, from the program's
`kernels.COUNTS` pass counters (`unet_graph.capture`, `.replay`, `.eager`:
one count a pass) when the run's metrics are read. Set-up's captures are in
the count. A CPU run, or a program without the counters, reads nothing."""


def read(ctx):
    import torch

    if not torch.cuda.is_available():
        return None
    try:
        from dreamscene_tpu_torch import kernels
    except ImportError:
        return None
    c = kernels.COUNTS
    passes = sum(c.get(f"unet_graph.{k}", 0) for k in ("capture", "replay", "eager"))
    return 100.0 * c.get("unet_graph.replay", 0) / passes if passes else None
