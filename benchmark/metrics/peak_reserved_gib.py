"""peak_reserved_gib: torch.cuda.max_memory_reserved() from the end of
set-up to the time the metrics are read (the window and the traced steps),
GiB: the memory that PyTorch's caching allocator held from the card, the
private pools of CUDA graphs included, which `peak_mem_gib`'s
max_memory_allocated() leaves out once a graph is captured. Nothing on the
CPU."""


def read(ctx):
    import torch

    if not torch.cuda.is_available():
        return None
    return torch.cuda.max_memory_reserved() / 2**30
