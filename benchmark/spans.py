"""The program's ranges read out of a `trace.Trace`: where the device's idle
time goes, and how many blocking synchronizations the host makes.

  * `idle_by_span(tr)` charges each idle gap of the device to the program
    range that issued the work ending it: the innermost (shortest) device-side
    window of a range that holds the start of the device event after the gap,
    or NO_SPAN where none does.
  * `step_syncs(tr, step)` counts the CUDA runtime's blocking
    synchronizations (SYNC_CALLS) among the trace's host operations, less the
    device-wide ones that close the trace (the harness's and the profiler's
    own); None when the program gave the step range `step` no window.

For an operator, `capture_spans` traces as `trace.capture` does and also
keeps the host side of the program's ranges, with the thread that opened
each (the backward's ranges open on autograd's thread), so that each
synchronization can be put down to the range open around it:

    python3 -m benchmark.spans --workload <cell> --seed <n> [--steps 6] \
        [--step-range fps.step]

sets the cell up as `run.py` does, traces its steps and prints one JSON line:
the device time a step by the innermost range window holding each event's
start (`busy_spans`), the idle time a step by range (`idle_spans`), the
synchronizations a step by the innermost host span open around each on its
thread (`sync_spans`, the closing ones under NO_SPAN) and `step_syncs` a
step (`syncs_per_step`), in ms and counts.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import trace as T  # noqa: E402

# CUDA runtime calls that block the host until the device has caught up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
NO_SPAN = "(no span)"


def innermost(windows, t: float) -> str:
    """The name of the shortest (start, end, name) window with start <= t <
    end, or NO_SPAN."""
    held = [(e - s, n) for s, e, n in windows if s <= t < e]
    return min(held)[1] if held else NO_SPAN


def windows_of(tr: T.Trace) -> list:
    return [(s, e, n) for n, ws in tr.ranges.items() for s, e in ws]


def idle_by_span(tr: T.Trace, min_gap_us: float = 5.0) -> list:
    """Idle device seconds by the range whose window holds the event that
    ends each gap (gaps shorter than `min_gap_us` left out), largest first."""
    merged = T.merge([(s, e) for s, e, _ in tr.busy])
    windows = windows_of(tr)
    out = {}
    for (_, end), (nxt, _) in zip(merged[:-1], merged[1:]):
        if nxt - end >= min_gap_us:
            label = innermost(windows, nxt)
            out[label] = out.get(label, 0.0) + (nxt - end) / 1e6
    return sorted(out.items(), key=lambda kv: -kv[1])


def busy_by_span(tr: T.Trace) -> list:
    """Device seconds by the innermost range window holding each event's
    start, largest first."""
    windows = windows_of(tr)
    out = {}
    for s, e, _ in tr.busy:
        label = innermost(windows, s)
        out[label] = out.get(label, 0.0) + (e - s) / 1e6
    return sorted(out.items(), key=lambda kv: -kv[1])


def step_syncs(tr: T.Trace, step: str) -> int | None:
    """The blocking synchronizations the traced steps made. The trace holds
    the steps, then the harness's `torch.cuda.synchronize()` and the
    profiler's own on leaving its context, both `cudaDeviceSynchronize`:
    the run of those that ends the trace is left out (the program's own
    syncs are copies and reads, `cudaStreamSynchronize`). None when the
    program gave the range `step` no device window."""
    if not tr.ranges.get(step):
        return None
    syncs = sorted((s, n) for s, _, n in tr.host if n in SYNC_CALLS)
    while syncs and syncs[-1][1] == "cudaDeviceSynchronize":
        syncs.pop()
    return len(syncs)


def syncs_by_span(spans: list, syncs: list) -> list:
    """Synchronizations (start_us, end_us, name, thread) counted by the
    innermost host span (start_us, end_us, name, thread) open around each on
    its thread, or NO_SPAN where none is; largest first."""
    out = {}
    for s, _, _, thread in syncs:
        label = innermost([(a, b, m) for a, b, m, t in spans if t == thread], s)
        out[label] = out.get(label, 0) + 1
    return sorted(out.items(), key=lambda kv: -kv[1])


def capture_spans(fn, n_steps: int, sync):
    """`trace.capture`'s Trace of `fn()`, and the host side of the
    program's ranges and the host's blocking synchronizations, each a list
    of (start_us, end_us, name, thread)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    busy, ranges, host, spans, syncs = [], {}, [], [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if T._is_range(e):
                ranges.setdefault(e.name, []).append((s, t))
            else:
                busy.append((s, t, e.name))
        elif getattr(e, "is_user_annotation", False):
            spans.append((s, t, e.name, e.thread))
        else:
            host.append((s, t, e.name))
            if e.name in SYNC_CALLS:
                syncs.append((s, t, e.name, e.thread))
    tr = T.Trace(busy=busy, ranges=ranges, host=host, wall_s=wall, n_steps=n_steps)
    return tr, spans, syncs


def main(argv=None) -> int:
    import importlib

    from benchmark import manifest, run

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--step-range", default="fps.step")
    args = p.parse_args(argv)
    m = manifest.load()
    cell = manifest.cell(m, args.workload)
    cfg = json.loads(manifest.config_file(m, cell["config"]).read_text())
    traffic = json.loads(manifest.traffic_file(cell["traffic"]).read_text())
    run.set_environment(cfg)
    import torch

    torch.set_num_threads(1)
    cells = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    with tempfile.TemporaryDirectory(prefix="dsspans_") as workdir:
        c = cells.Cell(cfg, traffic, args.seed, "cuda", workdir)
        c.setup()
        n = args.steps
        tr, spans, syncs = capture_spans(lambda: c.traced(n), n, torch.cuda.synchronize)
    per = {"busy_spans": busy_by_span(tr), "idle_spans": idle_by_span(tr)}
    out = {k: {name: v * 1e3 / n for name, v in rows} for k, rows in per.items()}
    out["sync_spans"] = {name: v / n for name, v in syncs_by_span(spans, syncs)}
    out.update(busy_ms=tr.busy_s * 1e3 / n, wall_ms=tr.wall_s * 1e3 / n, steps=n,
               card=run.power_limit())
    n_syncs = step_syncs(tr, args.step_range)
    out["syncs_per_step"] = None if n_syncs is None else n_syncs / n
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
