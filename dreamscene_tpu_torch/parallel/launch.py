"""Run a function on several ranks of one machine, without torchrun.

`run_ranks(fn, world, args)` spawns `world` processes (the `spawn` start
method), joins them into one process group through a file store, calls
`fn(rank, world, *args)` on each and waits for all of them, at most
`timeout_s` seconds. A rank that raises, exits non-zero or outlives the
timeout fails the call: the others are stopped and a RuntimeError carries
the rank's traceback. The tests run their CPU ranks through it, and
`chip_smoke.py` its ranks sharing one card over gloo.
"""

from __future__ import annotations

import datetime
import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, fn, world, store, backend, device, threads, timeout_s, args):
    torch.set_num_threads(threads)
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method=f"file://{store}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, args=(), *, device: str, store_dir: str, backend: str = "gloo",
              threads: int = 1, timeout_s: float = 120.0) -> None:
    """fn(rank, world, *args) on `world` ranks (fn must be importable by
    name: a module-level function). `device` is where each rank's tensors
    live, always named by the caller: "cpu", or "cuda:0" for ranks that
    share one card over gloo (raises without CUDA); `timeout_s` bounds
    each collective and the whole run."""
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(f"run_ranks on {device}: CUDA is not available")
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(store_dir, f"store_{os.getpid()}_{time.monotonic_ns()}")
    ctx = mp.start_processes(_entry, args=(fn, world, store, backend, device, threads,
                                           timeout_s, tuple(args)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise RuntimeError(f"{world} ranks of {fn.__name__} outlived {timeout_s:.0f} s")
    except mp.ProcessRaisedException as e:
        raise RuntimeError(f"a rank of {fn.__name__} failed:\n{e}") from None
    except mp.ProcessExitedException as e:
        raise RuntimeError(f"a rank of {fn.__name__} exited with code {e.exit_code}") from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
