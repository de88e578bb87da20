"""UNet passes replayed from CUDA graphs.

A UNet pass at SD 2.1 width (with the ControlNet's, when a hint is given)
is some 2,000 kernels, launched one by one from Python; at the
16x16 and 8x8 latent levels a kernel is shorter than the host's time to
launch it, and the ladder starts every pass from an empty queue after its
rung's `ddim_step`. `UNetPasses` captures a pass once and replays it as
one graph launch.

What a call observes decides the path; there is no knob:
  * eager (`unet_graph.eager`): a CPU tensor among the inputs, autograd
    recording (`torch.is_grad_enabled()`), or a stream already capturing;
    and a key's first `CAPTURE_AT - 1` passes;
  * capture (`unet_graph.capture`), a key's `CAPTURE_AT`-th pass: one
    eager warm-up pass on the cache's side stream (the `torch.cuda.graphs`
    recipe: cuBLAS and cuDNN set up their per-stream state before the
    capture), whose output the call returns, then the capture of the same
    pass on static copies of the inputs into a static output;
  * replay (`unet_graph.replay`): the inputs copied into the static
    buffers (device to device, no sync), the graph replayed, a clone of the
    static output returned: the ladder keeps every rung's eps until
    `csd_grad`, so a view would leave every rung reading the last one's.
At SD 2.1 width on an H100 the capturing call takes what 4-6 eager
passes take, and a replay saves 8 ms (batch 12) to 31 ms (batch 3)
against an eager pass, so a capture repays itself only over many passes:
one ladder is at most 5 passes (`mtsd.build_rand_ladder`'s 4 rungs and
t = 0), so a key that one ladder alone uses (validate.py's, or the
training visualization's at a batch the step does not use) stays eager,
and a key the training step uses is captured in its first few steps.
A key's eager passes are remembered for the `SEEN` keys used last; a key
evicted from the cache counts again from nothing, and a captured key whose
weights changed is captured again at once.
Each pass adds one to exactly one of the three counters in
`kernels.COUNTS`. A capture leaves `COUNTS` as its warm-up left it (the
capture launches nothing) and records the kernel counts its pass added
(K4's `flash_fwd`, `flash_fwd.tc`); each replay adds them again, so the
kernel counters count replayed passes too.

The key: the modules, by identity (the UNet, and the ControlNet when a
hint is given), and the shape, dtype and device of each input, an absent
hint included. Strides are not in the key: an input is copied into its
static buffer whatever its layout.

Memory: every capture of a cache allocates from one pool
(`torch.cuda.graph_pool_handle()`). That is safe because passes never
overlap and a replay's output is cloned before the next replay: one
graph's temporaries may lie where another keeps its static output, and
that output is never read after the clone. At most `CAPACITY` keys are
held, the least recently used evicted; an evicted graph frees its static
buffers, and once the cache is empty the pool goes with its last graph.

Weights: a graph reads each weight where it lay at the capture. An
update in place (`copy_`, `load_state_dict`) is read by the next replay.
A weight or a submodule replaced after the capture (a new Parameter, an
assignment to `.data`, a module swapped) is detected before every replay:
the entry holds every submodule, parameter and buffer of the modules it
captured, by the dict and name that holds it, and compares identity and
data pointer (~0.2 ms a pass at SD 2.1 width on the host). A change drops
the entry and the call captures again. The entry holds those tensors, so
their memory cannot be handed to another tensor while it lives.

What a replay does not do: forward hooks on the modules do not run, and
profiler ranges opened inside the pass (`sd.attention`) do not open; the
replayed kernels fall inside the ranges open around the call
(`fps.ladder`), which their graph launch correlates with.
"""

from __future__ import annotations

import collections
from typing import Callable, Sequence

import torch

from dreamscene_tpu_torch import kernels

CAPACITY = 4      # captured keys held
CAPTURE_AT = 6    # the pass of a key that captures it (module docstring)
SEEN = 64         # keys whose eager passes are counted
CAPTURE, REPLAY, EAGER = "unet_graph.capture", "unet_graph.replay", "unet_graph.eager"


def graphable(tensors: Sequence[torch.Tensor]) -> bool:
    """Whether a pass over these inputs can be captured or replayed: no
    autograd recording, every tensor on the card, no capture under way
    (checked last: the CPU build has no capture query)."""
    return (not torch.is_grad_enabled() and all(t.is_cuda for t in tensors)
            and not torch.cuda.is_current_stream_capturing())


def pass_key(modules: Sequence[torch.nn.Module], args: Sequence[torch.Tensor | None]):
    return (tuple(id(m) for m in modules),
            tuple(None if a is None else (tuple(a.shape), a.dtype, a.device) for a in args))


class Weights:
    """Every submodule, parameter and buffer of `modules` as the dict and
    name that hold it, with each tensor's data pointer; `unchanged()` says
    whether each is still there, the same object at the same address."""

    def __init__(self, modules: Sequence[torch.nn.Module]):
        self.modules = tuple(modules)       # held: no other module takes their ids
        self.slots = [(d, name, obj) for top in self.modules for m in top.modules()
                      for d in (m._modules, m._parameters, m._buffers)
                      for name, obj in d.items()]
        self.ptrs = [(t, t.data_ptr()) for _, _, t in self.slots
                     if isinstance(t, torch.Tensor)]

    def unchanged(self) -> bool:
        return (all(d.get(name) is obj for d, name, obj in self.slots)
                and all(t.data_ptr() == p for t, p in self.ptrs))


class CapturedPass:
    """One pass of `fn` captured: its static inputs, graph and static
    output, the kernel counts its pass adds, and the weights it reads.
    `out` is the warm-up's output, the answer of the call that captured."""

    def __init__(self, fn: Callable, modules, args, shared: dict):
        dev = next(a for a in args if a is not None).device
        self.weights = Weights(modules)
        with torch.cuda.device(dev):
            if dev not in shared:
                shared[dev] = (torch.cuda.Stream(dev), torch.cuda.graph_pool_handle())
            stream, pool = shared[dev]
            self.static = [None if a is None else a.clone() for a in args]
            cur = torch.cuda.current_stream(dev)
            stream.wait_stream(cur)
            with torch.cuda.stream(stream):
                self.out = fn(*self.static)
            cur.wait_stream(stream)
            self.out.record_stream(cur)
            before = kernels.COUNTS.copy()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                self.static_out = fn(*self.static)
        self.counts = kernels.COUNTS - before
        kernels.COUNTS.subtract(self.counts)

    def fresh(self) -> bool:
        return self.weights.unchanged()

    def replay(self, args) -> torch.Tensor:
        for s, a in zip(self.static, args):
            if s is not None:
                s.copy_(a)
        self.graph.replay()
        kernels.COUNTS.update(self.counts)
        return self.static_out.clone()


class UNetPasses:
    """The captured passes of one guidance stack: `__call__(fn, modules,
    args)` returns `fn(*args)`, eager, captured or replayed (module
    docstring)."""

    def __init__(self):
        self.entries: collections.OrderedDict = collections.OrderedDict()  # key -> CapturedPass
        self.seen: collections.OrderedDict = collections.OrderedDict()     # key -> eager passes
        self.shared: dict = {}     # device -> (side stream, memory pool) of the captures

    def __call__(self, fn: Callable, modules, args):
        if not graphable([a for a in args if a is not None]):
            return self.eager(fn, args)
        key = pass_key(modules, args)
        entry = self.entries.get(key)
        if entry is not None and entry.fresh():
            self.entries.move_to_end(key)
            kernels.COUNTS[REPLAY] += 1
            return entry.replay(args)
        if entry is None:
            n = self.seen.pop(key, 0) + 1
            if n < CAPTURE_AT:
                self.seen[key] = n
                if len(self.seen) > SEEN:
                    self.seen.popitem(last=False)
                return self.eager(fn, args)
        self.drop(key)
        while len(self.entries) >= CAPACITY:
            self.drop(next(iter(self.entries)))
        entry = CapturedPass(fn, modules, args, self.shared)
        out, entry.out = entry.out, None
        self.entries[key] = entry
        kernels.COUNTS[CAPTURE] += 1
        return out

    @staticmethod
    def eager(fn: Callable, args):
        kernels.COUNTS[EAGER] += 1
        return fn(*args)

    def drop(self, key) -> None:
        self.entries.pop(key, None)
        if not self.entries:
            self.shared.clear()
