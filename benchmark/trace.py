"""Reading a torch.profiler window: device activity, program ranges, idle gaps.

`capture(fn)` runs `fn()` under torch.profiler (CPU and CUDA activities) with
the card synchronized before and after, and returns a `Trace`:

  * `busy` holds the device intervals (kernels, copies, sets): every device
    event that is not one of the program's ranges. `busy_s` is the length of
    their union, so kernels that overlap count once.
  * `ranges` holds the device-side windows of the program's profiler ranges
    (`torch.profiler.record_function`, e.g. the object step's `fps.render`).
  * `in_ranges(names)` sums the device time of the events that start inside
    any window of the named ranges.
  * `breakdown()` names the device operations that took most time, and the
    host operation that was running at the start of each idle gap of the
    device, summed by that operation's name.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

# device-side events with these name prefixes are the program's ranges, not
# device work (a fallback where the profiler does not mark user annotations)
RANGE_PREFIXES = ("fps.", "scene.", "recon.", "controlnet", "ProfilerStep")


@dataclasses.dataclass
class Trace:
    busy: list            # (start_us, end_us, name) of device activity
    ranges: dict          # range name -> [(start_us, end_us), ...] on the device
    host: list            # (start_us, end_us, name) of host operations
    wall_s: float         # the traced window, host clock
    n_steps: int

    @property
    def busy_s(self) -> float:
        return union_length([(s, e) for s, e, _ in self.busy]) / 1e6

    def kernels(self, pattern: str) -> list:
        """(start_us, end_us) of the device events whose name holds `pattern`."""
        return [(s, e) for s, e, n in self.busy if pattern in n]

    def in_ranges(self, names) -> float | None:
        """Device seconds of the events starting inside any window of the
        ranges `names`; None when no such range was recorded."""
        windows = [w for n in names for w in self.ranges.get(n, [])]
        if not windows:
            return None
        lo = np.array([w[0] for w in windows])
        hi = np.array([w[1] for w in windows])
        total = 0.0
        for s, e, _ in self.busy:
            if np.any((lo <= s) & (s < hi)):
                total += e - s
        return total / 1e6

    def breakdown(self, top: int = 10) -> dict:
        ops = {}
        for s, e, n in self.busy:
            ops[n] = ops.get(n, 0.0) + (e - s) / 1e6
        device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], v] for n, v in device_ops],
                "idle_gaps": [[n[:120], v] for n, v in self.idle_by_host_op()[:top]]}

    def idle_by_host_op(self, min_gap_us: float = 5.0) -> list:
        """Idle device time, summed by the innermost host operation open at
        the start of each gap (gaps shorter than `min_gap_us` left out)."""
        merged = merge([(s, e) for s, e, _ in self.busy])
        if not merged or not self.host:
            return []
        hs = np.array([h[0] for h in self.host])
        he = np.array([h[1] for h in self.host])
        dur = he - hs
        names = [h[2] for h in self.host]
        out = {}
        for (_, end), (nxt, _) in zip(merged[:-1], merged[1:]):
            gap = nxt - end
            if gap < min_gap_us:
                continue
            open_ = np.nonzero((hs <= end) & (he > end))[0]
            label = names[open_[np.argmin(dur[open_])]] if open_.size else "(no host op)"
            out[label] = out.get(label, 0.0) + gap / 1e6
        return sorted(out.items(), key=lambda kv: -kv[1])


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_length(intervals) -> float:
    return float(sum(e - s for s, e in merge(intervals)))


def _is_range(e) -> bool:
    if getattr(e, "is_user_annotation", False):
        return True
    return e.name.startswith(RANGE_PREFIXES)


def capture(fn, n_steps: int, sync) -> Trace:
    """`fn()` under torch.profiler, the device synchronized (`sync()`)
    before and after."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    busy, ranges, host = [], {}, []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if _is_range(e):
                ranges.setdefault(e.name, []).append((s, t))
            else:
                busy.append((s, t, e.name))
        elif not getattr(e, "is_user_annotation", False):
            host.append((s, t, e.name))
    return Trace(busy=busy, ranges=ranges, host=host, wall_s=wall, n_steps=n_steps)
