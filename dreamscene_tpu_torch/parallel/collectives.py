"""The collectives of the sharded render and the mesh steps, with their
backwards.

Only `all_reduce`, `all_gather` and `broadcast` are used: NCCL implements
them for CUDA tensors and gloo for CPU and CUDA tensors (checked on the
H100 machine with torch 2.11, four ranks sharing cuda:0). A reduce-scatter is an
all-reduce followed by a slice (gloo's reduce_scatter support varies by
version). A group of None is an axis of size 1: every function is then
the identity and makes no call.

Two all-gathers, differing in their backward:
  * `all_gather` is the true VJP of a tiled all-gather (JAX's
    `all_gather`, transposed to `psum_scatter`): the cotangents of every
    rank are summed and each rank keeps its own slice. The projected
    records of a splat shard and the cross-band disparity statistics go
    through it, because every rank uses them for different work (its own
    band).
  * `gather_replicated` is for a tensor that every rank of the group then
    feeds through the SAME computation (the full images of a dp group's
    cameras, which each of its tp ranks encodes and scores): its backward
    keeps the rank's own slice of its own cotangent and makes no call, so
    a term computed redundantly by the n_tp ranks reaches each band once.
"""

from __future__ import annotations

import collections
import time

import torch
import torch.distributed as dist

# host seconds inside collective calls (gloo returns when the data is
# there; NCCL only enqueues, so with NCCL this is enqueue time) and bytes
# each rank received from all-gathers; `reset_stats` zeroes them
STATS: collections.Counter = collections.Counter()


def reset_stats() -> None:
    STATS.clear()
    STATS.update(calls=0, seconds=0.0, bytes_gathered=0)


def _record(t0: float, nbytes: int = 0) -> None:
    STATS["calls"] += 1
    STATS["seconds"] += time.perf_counter() - t0
    STATS["bytes_gathered"] += nbytes


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along `dim` in group-rank order
    (no autograd). Every rank's tensor has the same shape."""
    if group is None:
        return x
    if x.dtype == torch.bool:        # gloo has no bool reductions or gathers
        return all_gather_cat(x.to(torch.uint8), group, dim).bool()
    x = x.contiguous()
    n = dist.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(n)]
    t0 = time.perf_counter()
    dist.all_gather(parts, x, group=group)
    _record(t0, (n - 1) * x.numel() * x.element_size())
    return torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of `x` over `group`; returns `x`."""
    if group is not None:
        t0 = time.perf_counter()
        dist.all_reduce(x, op=op, group=group)
        _record(t0)
    return x


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """In-place broadcast of `x` from global rank `src` over `group`."""
    if group is not None:
        t0 = time.perf_counter()
        dist.broadcast(x, src, group=group)
        _record(t0)
    return x


def _own_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    return x.chunk(n, dim=dim)[dist.get_rank(group)].contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous().clone(), ctx.group)
        return _own_slice(g, ctx.group, ctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.group, ctx.dim), None, None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Tiled all-gather whose backward sums the group's cotangents and
    keeps this rank's slice (a reduce-scatter)."""
    if group is None:
        return x
    return _AllGather.apply(x, group, dim)


def gather_replicated(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Tiled all-gather for a result every rank of `group` consumes the
    same way: the backward keeps this rank's slice of its own cotangent."""
    if group is None:
        return x
    return _GatherReplicated.apply(x, group, dim)


def all_reduce_flat(tensors: list, group) -> list:
    """Sum each tensor over `group` with one all-reduce of their
    concatenation; returns new tensors of the inputs' shapes."""
    if group is None or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    all_reduce(flat, group)
    out, o = [], 0
    for t in tensors:
        out.append(flat[o:o + t.numel()].reshape(t.shape).to(t.dtype))
        o += t.numel()
    return out
