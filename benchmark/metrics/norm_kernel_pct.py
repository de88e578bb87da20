"""norm_kernel_pct: the share, in %, of the SD modules' norm work on the
card that hand-written kernels did, counted in elements: the elements the
norm kernels read (`kernels.COUNTS["norm.kernel_elems"]`, every forward,
replayed UNet passes included) over those plus the elements whose backward
ran as PyTorch ops (`"norm.torch_elems"`: the VAE encoder differentiated in
every FPS step, until a backward kernel exists), when the run's metrics are
read. Set-up's norms are in the count. A CPU run, or a program without the
counters, reads nothing."""


def read(ctx):
    import torch

    if not torch.cuda.is_available():
        return None
    try:
        from dreamscene_tpu_torch import kernels
    except ImportError:
        return None
    c = kernels.COUNTS
    kernel = c.get("norm.kernel_elems", 0)
    total = kernel + c.get("norm.torch_elems", 0)
    return 100.0 * kernel / total if total else None
