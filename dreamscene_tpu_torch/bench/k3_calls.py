"""What one K3 call costs the host, and how many device kernels it issues.

    python -m dreamscene_tpu_torch.bench.k3_calls

On the full-width scene of chip_smoke.py (bench/scenes.py: 50K splats,
512^2, 32x16 tiles) it times `ops.expand.expand_entries` as the binning
calls it: host wall ms per call without a sync (the thread that issues the
step's work spends this), over 200 calls after a warm one, three times;
then counts the device kernels of 10 calls under torch.profiler and names
them. It uses only `expand_entries` and `bench/scenes.py`, so the same file
run inside an older checkout of the repository times that checkout's call
the same way (put a copy of this file there). One JSON line. Needs one CUDA
card and nvcc.
"""

from __future__ import annotations

import collections
import json
import subprocess
import sys
import tempfile
import time

import torch

from dreamscene_tpu_torch import kernels
from dreamscene_tpu_torch.bench import scenes
from dreamscene_tpu_torch.ops import expand as E

CALLS = 200


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_calls: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    kernels.lib()
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cache = tempfile.mkdtemp(prefix="k3_calls_init_", dir=kernels.BUILD_DIR)
    st, cam = scenes.make_scene(50_000, 512, 512, 50_000, cache)
    kw = scenes.binned_inputs(st, cam, 32, 16)["ex"]["kwargs"]

    host_ms = []
    for _ in range(3):
        E.expand_entries(**kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            E.expand_entries(**kw)
        host_ms.append((time.perf_counter() - t0) * 1e3 / CALLS)
        torch.cuda.synchronize()

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            E.expand_entries(**kw)
        torch.cuda.synchronize()
    names = collections.Counter(e.name[:60] for e in prof.events()
                                if e.device_type == torch.autograd.DeviceType.CUDA)
    print(json.dumps({"card": card, "call_host_ms": host_ms,
                      "device_kernels_per_call": sum(names.values()) / 10,
                      "device_kernels": {k: v / 10 for k, v in names.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
