"""Profiling helpers and the card's peak rates, port of the JAX package's
utils/profiling.py.

The peaks are those of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). They are the one
place that holds them: `roofline` defaults to them, and chip_smoke.py's
kernel bounds read them.
"""

from __future__ import annotations

import contextlib
import logging
import os
import random
import time

import numpy as np
import torch

logger = logging.getLogger("dreamscene_tpu_torch")

H100_BF16_FLOPS = 989e12     # dense bf16 on the tensor cores
H100_FP32_FLOPS = 67e12      # float32 outside the tensor cores
H100_HBM_BYTES_PER_S = 3.35e12


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the CPU and, where there is one, the CUDA card;
    on exit the Chrome trace is written into `log_dir`
    (trace_<pid>.json)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


@contextlib.contextmanager
def timed(name: str, sync=None):
    """Wall-clock block timer, logged as "<name>: <ms> ms". `sync` is a
    tensor or a nested list / tuple / dict of them: the CUDA device of each
    is synchronized before the clock is read, so the time covers the work
    queued for them."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            for dev in {t.device for t in _tensors(sync) if t.is_cuda}:
                torch.cuda.synchronize(dev)
        logger.info("%s: %.2f ms", name, (time.perf_counter() - t0) * 1e3)


def device_busy_ms(fn, skip=()) -> float:
    """Summed spans of the CUDA kernels and copies that one `fn()` queues
    (torch.profiler, the card synchronized before and after): the device
    busy time of a process alone on the card. Device-side events named with
    a prefix in `skip` (profiler ranges the caller opened) are left out."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    skip = tuple(skip)
    return sum((e.time_range.end - e.time_range.start) / 1e3 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not (skip and e.name.startswith(skip)))


def roofline(flops: float, bytes_moved: float, seconds: float,
             peak_flops: float = H100_BF16_FLOPS,
             peak_bw: float = H100_HBM_BYTES_PER_S) -> dict:
    """Roofline summary against one H100's bf16 and HBM peaks by default."""
    achieved_flops = flops / seconds
    achieved_bw = bytes_moved / seconds
    return {
        "achieved_tflops": achieved_flops / 1e12,
        "flops_frac": achieved_flops / peak_flops,
        "achieved_gbps": achieved_bw / 1e9,
        "bw_frac": achieved_bw / peak_bw,
        "arithmetic_intensity": flops / max(bytes_moved, 1),
    }


def seed_everything(seed: int):
    """Global seeding as the JAX package does it (reference:
    training/object_trainer.py:59-72): Python's and numpy's global
    generators and PYTHONHASHSEED."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
