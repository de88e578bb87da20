"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit). A card set below 700 W
runs slower under load: every result line carries the card's power limit."""

BF16_FLOPS = 989e12      # bf16 / fp16 on the tensor cores
FP32_FLOPS = 67e12       # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def least_ms(ops: float, nbytes: float, peak_flops: float = FP32_FLOPS) -> tuple[float, str]:
    """The least time one H100 could take (ms) and what bounds it: the
    operations over the peak rate of their precision, or the bytes over
    HBM's rate."""
    t_ops = ops / peak_flops * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
