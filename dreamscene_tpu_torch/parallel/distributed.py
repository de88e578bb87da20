"""Multi-process runtime and rank layouts, torch.distributed.

Port of dreamscene_tpu/parallel/distributed.py. The JAX package drives
every device from one process through `jax.shard_map`; PyTorch's idiom is
one process per device (a "rank"), launched by `torchrun`:

    torchrun --nproc-per-node 4 -m dreamscene_tpu_torch --config C.yaml \
        parallelParams.dp=2 parallelParams.tp=2

`initialize_runtime` reads torchrun's environment (WORLD_SIZE, RANK,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR / MASTER_PORT) and does nothing
for a single process, as the JAX function does. The backend is `nccl` for
CUDA and `gloo` for the CPU, never switched on failure; `gloo` on CUDA
tensors only when the caller asks for it (several ranks sharing one card,
which NCCL refuses).

`Mesh` lays ranks out row-major over named axes: rank r of a ("dp", "tp")
mesh sits at (dp_i, tp_i) = divmod(r, n_tp), JAX's
`np.asarray(devices).reshape(n_dp, n_tp)`. For each axis, the ranks that
share every other coordinate form one process group. The groups are
`dist.new_group`s, created by every rank in the same order:
`torch.distributed.device_mesh.DeviceMesh` would give each rank a card of
its own (rank % device count), which the one-card gloo run breaks, and the
trainers need nothing of it beyond the groups.
"""

from __future__ import annotations

import datetime
import itertools
import logging
import math
import os

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

# a collective that waits longer fails the run
TIMEOUT = datetime.timedelta(minutes=10)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def from_rank0(fn):
    """fn() run on rank 0 alone; every rank returns its result (pickled
    and broadcast), so host state that rank 0 draws or reads is the same
    everywhere."""
    if not dist.is_initialized():
        return fn()
    box = [fn() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def initialize_runtime(device: str | torch.device | None = None,
                       backend: str | None = None) -> torch.device:
    """Join the process group torchrun describes and return this rank's
    device: `cuda:LOCAL_RANK` (or the CPU when `device` is "cpu"). A single
    process (WORLD_SIZE unset or 1) joins nothing and gets `device` as it
    is ("cuda" by default). With `nccl`, two local ranks on one card
    raise."""
    dev = torch.device(device or "cuda")
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world <= 1:
        return dev
    rank_ = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError("CUDA is not available; pass device='cpu' for CPU ranks")
        if backend == "nccl" and local_world > n_cards:
            raise RuntimeError(
                f"nccl: {local_world} local ranks but {n_cards} card(s); NCCL refuses "
                "two ranks on one card (ask for backend='gloo' to share it)")
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank_,
                            timeout=TIMEOUT)
    log.info("torch.distributed up: rank %d/%d (local %d/%d), %s on %s",
             rank_, world, local_rank, local_world, backend, dev)
    return dev


class Mesh:
    """Ranks laid out row-major over named axes (the role of jax's Mesh).

    `shape[axis]` is the axis size, `coords[axis]` this rank's index on
    it, `group(axis)` the process group of the ranks that differ from this
    one on `axis` alone (None when the axis has size 1), `ranks_of(axis)`
    their global ranks in axis order, `world_group` the group of every
    rank of the mesh (None for one rank). `ranks` are the global ranks of the
    mesh in row-major order (default: 0 .. size-1)."""

    def __init__(self, shape: dict, ranks=None):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.size = math.prod(self.shape.values())
        self.ranks = list(range(self.size)) if ranks is None else list(ranks)
        if len(self.ranks) != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} ranks, got {len(self.ranks)}")
        me = rank()
        if me not in self.ranks:
            raise ValueError(f"rank {me} is not in the mesh's ranks {self.ranks}")
        sizes = [self.shape[a] for a in self.axis_names]
        pos = self.ranks.index(me)
        self.coords = {}
        for a, s in zip(reversed(self.axis_names), reversed(sizes)):
            pos, self.coords[a] = divmod(pos, s)
        self._groups = {}
        grid = list(itertools.product(*[range(s) for s in sizes]))
        for ax_i, axis in enumerate(self.axis_names):
            lines: dict = {}
            for c in grid:
                key = c[:ax_i] + c[ax_i + 1:]
                lines.setdefault(key, []).append(self.ranks[grid.index(c)])
            for members in lines.values():
                # new_group is collective over the default group: every
                # rank creates every group, in the same order
                g = dist.new_group(members) if len(members) > 1 else None
                if me in members:
                    self._groups[axis] = (g, members)
        if self.size == 1:
            self.world_group = None
        elif self.size == world_size():
            self.world_group = dist.group.WORLD
        else:
            self.world_group = dist.new_group(self.ranks)

    def group(self, axis: str):
        return self._groups[axis][0]

    def ranks_of(self, axis: str) -> list:
        return self._groups[axis][1]


def make_hybrid_mesh(n_dp: int, n_tp: int, dcn_dp: int | None = None) -> Mesh:
    """("ddp", "dp", "tp") mesh whose outer data-parallel axis spans the
    nodes: torchrun numbers the ranks of a node consecutively, so with dp x
    tp ranks per node the row-major layout keeps a node's ranks on the
    inner axes (the per-camera record gathers stay inside a node) and only
    the once-per-step gradient all-reduce crosses nodes. `dcn_dp`
    defaults to the number of whole dp x tp groups in the world, at most
    one per node."""
    n_inner = n_dp * n_tp
    world = world_size()
    if dcn_dp is None:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)) or world)
        dcn_dp = min(max(1, world // max(n_inner, 1)), max(1, world // max(local_world, 1)))
    if world < dcn_dp * n_inner:
        raise ValueError(f"world size {world} < ddp {dcn_dp} x dp {n_dp} x tp {n_tp}")
    return Mesh({"ddp": dcn_dp, "dp": n_dp, "tp": n_tp})
