"""Profiling helpers and the card's peak rates, port of the JAX package's
utils/profiling.py.

The peaks are those of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). They are the one
place that holds them: `roofline` defaults to them, and chip_smoke.py's
kernel bounds read them.

`BackwardSpans` marks stretches of a step's backward pass as profiler
ranges (`<phase>.<part>.bwd`), opened and closed on the thread that runs
the backward.
"""

from __future__ import annotations

import contextlib
import functools
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
    """Device busy time of one `fn()` (torch.profiler, the card
    synchronized before and after) in ms: the length of the union of the
    intervals of its CUDA kernels, copies and sets, so kernels that overlap
    count once; a process alone on the card. Profiler ranges are left out
    (device-side user annotations, and events named with a prefix in
    `skip`)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    return busy_ms_of(prof.events(), skip)


def busy_ms_of(events, skip=()) -> float:
    """`device_busy_ms`'s reading of a profiler's events."""
    skip = tuple(skip)
    intervals = sorted((e.time_range.start, e.time_range.end) for e in events
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)
                       and not (skip and e.name.startswith(skip)))
    total, reach = 0.0, float("-inf")
    for s, e in intervals:
        if e > reach:
            total += e - max(s, reach)
            reach = e
    return total / 1e3


class _OnBackward(torch.autograd.Function):
    """Identity; its backward calls `hook()` before passing the gradients
    on."""

    @staticmethod
    def forward(ctx, hook, *xs):
        ctx.hook = hook
        ctx.set_materialize_grads(False)
        return xs

    @staticmethod
    def backward(ctx, *grads):
        ctx.hook()
        return (None,) + grads


class BackwardSpans:
    """Profiler ranges over stretches of one step's backward pass.

    The backward runs on autograd's own thread on the card, where no range
    of the forward is open, so a range over part of it is opened and
    closed by that thread: `end(name, tensors)` passes the tensors that
    enter a stretch of the forward through an identity node whose backward
    closes the range `name` (the gradients leave the stretch there), and
    `begin(name, tensors)` passes the tensors that leave it through one
    whose backward opens it (their gradients have arrived). Both take a
    dict or a sequence and return the same kind, the tensors that require
    a gradient replaced by the node's outputs; the others pass as they
    are. With no profiler running when the object is made, both return
    their argument and the graph is unchanged.

    `close()` ends every range still open; the step calls it once its
    backward is done, so a backward that stops between the two nodes, or
    raises there, leaves no range open."""

    def __init__(self):
        self.on = torch.autograd._profiler_enabled()
        self._held: dict = {}

    def begin(self, name: str, tensors):
        return self._mark(functools.partial(self._enter, name), tensors)

    def end(self, name: str, tensors):
        return self._mark(functools.partial(self._exit, name), tensors)

    def _mark(self, hook, tensors):
        items = dict(tensors) if isinstance(tensors, dict) else dict(enumerate(tensors))
        keys = [k for k, t in items.items() if isinstance(t, torch.Tensor) and t.requires_grad]
        if self.on and keys:
            items.update(zip(keys, _OnBackward.apply(hook, *(items[k] for k in keys))))
        return items if isinstance(tensors, dict) else tuple(items.values())

    def _enter(self, name):
        if name not in self._held:
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            self._held[name] = rf

    def _exit(self, name):
        rf = self._held.pop(name, None)
        if rf is not None:
            rf.__exit__(None, None, None)

    def close(self):
        for name in list(self._held):
            self._exit(name)


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
