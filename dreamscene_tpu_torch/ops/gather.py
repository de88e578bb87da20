"""Exact 32-bit row gathers, the counterparts of the JAX package's
ops/gather.py `u16_row_gather` (float32) and `u16_row_gather_i32`
(int32).

The JAX package splits each 32-bit value into two uint16 halves before
gathering, because XLA's TPU gather ran about 5x faster per source row on
sub-32-bit elements; the halves are rebuilt bit for bit after. A CUDA
gather reads each 32-bit row directly from global memory at the same cost
per byte as a 16-bit one, so the card needs no halves layout: these are
plain row gathers, exact by construction (every bit pattern, -0.0 and NaN
payloads included, arrives unchanged).
"""

from __future__ import annotations

import torch


def row_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = src[idx[i]] for a float32 [n, w] table and integer indices."""
    return src.float().index_select(0, idx.long())


def row_gather_i32(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = src[idx[i]] for an int32 [n, w] table and integer indices."""
    return src.to(torch.int32).index_select(0, idx.long())
