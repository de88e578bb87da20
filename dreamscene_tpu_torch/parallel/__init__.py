"""Multi-rank training on torch.distributed (port of dreamscene_tpu/parallel)."""
