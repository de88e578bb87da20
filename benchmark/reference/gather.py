"""Exact 32-bit row gathers in plain PyTorch (frozen copy of the program's
plain version): every bit pattern arrives unchanged."""

from __future__ import annotations

import torch


def row_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = src[idx[i]] for a float32 [n, w] table and integer indices."""
    return src.float().index_select(0, idx.long())


def row_gather_i32(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = src[idx[i]] for an int32 [n, w] table and integer indices."""
    return src.to(torch.int32).index_select(0, idx.long())
