"""Rasterizer throughput on the card: pixels/s and Gaussians/s through a
forward + backward at 512x512 of a 300K-splat scene, gradients taken with
respect to every splat tensor. BASELINE.json's primary metric, measured as
the repo's bench.py measures it, through the port's `render`.

    python3 -m dreamscene_tpu_torch.bench.throughput      # one CUDA card

Prints ONE JSON line with bench.py's metric, value and unit.

Headline: the entry table sized as training sizes it (`tracked_capacity`:
the raw entry demand of this view x the controller's 1.1 pad, quantized to
N/4), so no entry drops; default tiles (32x16), chunk BENCH_CHUNK (512).
Companion (skipped with BENCH_SKIP_CAP4=1): BENCH_CAP_MULT (4) x N entries
at 16x16 tiles and chunk 384, which drops part of this dense scene's
entries. Each is one warm-up step, then ITERS steps timed by the host clock
with one synchronize at the end. The line also holds one step's device
busy time (torch.profiler) and its idle share of the timed step, and the
card's `nvidia-smi` name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

N_GAUSSIANS = 300_000
WIDTH = HEIGHT = 512
ITERS = 10
SH_DEGREE = 2
CAP_MULT = int(os.environ.get("BENCH_CAP_MULT", 4))
CHUNK = int(os.environ.get("BENCH_CHUNK", 512))
CAP4_TILE, CAP4_CHUNK = (16, 16), 384
PARAMS = ("means3d", "scales", "quats", "opacities", "shs")


def build_scene(n: int, seed: int = 0, sh_degree: int = SH_DEGREE) -> dict:
    """An indoor-like scene of n splats as numpy arrays: half on the shell
    of a 3.5 x 2.5 x 2.5 box, half N(0, 0.8^2) inside; unit quaternions, SH
    around grey, log-normal scales, sigmoid-normal opacities. One
    RandomState(seed), drawn in bench.py's order."""
    rng = np.random.RandomState(seed)
    k = (sh_degree + 1) ** 2
    n_shell = n // 2
    shell = rng.uniform(-1, 1, (n_shell, 3))
    axis = rng.randint(0, 3, n_shell)
    sign = rng.randint(0, 2, n_shell) * 2 - 1
    shell[np.arange(n_shell), axis] = sign
    shell *= np.array([3.5, 2.5, 2.5])
    interior = rng.randn(n - n_shell, 3) * 0.8
    pts = np.concatenate([shell, interior]).astype(np.float32)
    quats = rng.randn(n, 4).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    shs = (rng.randn(n, k, 3) * 0.2).astype(np.float32)
    shs[:, 0] += 0.5
    scales = np.exp(rng.randn(n, 3) * 0.3 - 3.2).astype(np.float32)
    opacities = (1 / (1 + np.exp(-rng.randn(n)))).astype(np.float32)
    return dict(means3d=pts, scales=scales, quats=quats, opacities=opacities, shs=shs)


def camera(width: int = WIDTH, height: int = HEIGHT):
    """The orbit camera: radius 4, theta 80, phi 30, 50 deg FoV."""
    from dreamscene_tpu_torch.bench.scenes import orbit_camera

    return orbit_camera(width, height)


def camera_tensors(cam, device) -> dict:
    return dict(viewmatrix=torch.as_tensor(cam.world_view_transform, device=device),
                projmatrix=torch.as_tensor(cam.full_proj_transform, device=device),
                campos=torch.as_tensor(cam.camera_center, device=device),
                tanfovx=cam.tanfovx, tanfovy=cam.tanfovy, width=cam.width,
                height=cam.height)


def render_view(params: dict, cam_t: dict, capacity: int, chunk: int = CHUNK, tile=None,
                device="cuda") -> dict:
    """The bench's render: SH degree 2 on a black background."""
    from dreamscene_tpu_torch.ops.rasterizer import render

    tile_w, tile_h = tile or (None, None)
    return render(**params, **cam_t, bg=torch.zeros(3, device=device), sh_degree=SH_DEGREE,
                  capacity=capacity, chunk=chunk, tile_w=tile_w, tile_h=tile_h,
                  device=device)


def loss_of(out) -> torch.Tensor:
    return out["image"].mean() + 0.1 * out["depth"].mean() + 0.01 * out["alpha"].mean()


def capacity_for(raw: int, n: int) -> int:
    """The table the capacity controller settles on for `raw` entries of n
    splats: raw x pad, quantized up to the next N/4."""
    from dreamscene_tpu_torch.training.capacity import CapacityController

    ctrl = CapacityController()
    ctrl.mult = ctrl._quantize(raw * ctrl.pad / n, n)
    return ctrl.capacity(n)


def tracked_capacity(params: dict, cam_t: dict, device="cuda") -> tuple[int, int]:
    """(capacity, raw entries): one forward at min(16 N, HARD_CAP) entries
    counts the raw demand n_entries + n_dropped of this view."""
    from dreamscene_tpu_torch.training.capacity import CapacityController

    n = params["means3d"].shape[0]
    with torch.no_grad():
        out = render_view(params, cam_t, min(16 * n, CapacityController.HARD_CAP),
                          device=device)
    raw = int(out["n_entries"]) + int(out["n_dropped"])
    return capacity_for(raw, n), raw


def step_fn(params: dict, cam_t: dict, capacity: int, chunk: int = CHUNK, tile=None,
            device="cuda"):
    """One forward + backward: returns (loss, n_dropped, gradients of the
    five splat tensors), all left on the device."""
    leaves = [params[k].detach().requires_grad_(True) for k in PARAMS]

    def step():
        out = render_view(dict(zip(PARAMS, leaves)), cam_t, capacity, chunk, tile, device)
        loss = loss_of(out)
        return loss.detach(), out["n_dropped"], torch.autograd.grad(loss, leaves)
    return step


def measure(step) -> tuple[float, int]:
    """(ms per step, n_dropped of the last step) on the card: one warm-up,
    then ITERS steps by the host clock with one synchronize at the end."""
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        _, n_dropped, _ = step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / ITERS, int(n_dropped)


def smi_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def main() -> dict:
    from dreamscene_tpu_torch.device import resolve_device
    from dreamscene_tpu_torch.ops.binning import DEFAULT_TILE_H, DEFAULT_TILE_W
    from dreamscene_tpu_torch.utils.profiling import device_busy_ms

    dev = resolve_device("cuda")
    params = {k: torch.as_tensor(v, device=dev) for k, v in build_scene(N_GAUSSIANS).items()}
    cam_t = camera_tensors(camera(), dev)
    pix = WIDTH * HEIGHT
    cap, raw = tracked_capacity(params, cam_t, dev)
    step = step_fn(params, cam_t, cap, device=dev)
    ms, n_dropped = measure(step)
    busy = device_busy_ms(step)
    pix_ps = pix / (ms / 1e3)
    result = {
        "metric": "pixels_per_s_fwd_bwd_512sq_300k_gaussians",
        "value": pix_ps,
        "unit": "pixels/s",
        "gaussians_per_s": N_GAUSSIANS * pix_ps / pix,
        "methodology": "controller_tracked_capacity",
        "capacity": cap,
        "raw_entries": raw,
        "entries_dropped": n_dropped,
        "tile": [DEFAULT_TILE_W, DEFAULT_TILE_H],
        "chunk": CHUNK,
        "ms_per_step": ms,
        "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / ms,
    }
    if os.environ.get("BENCH_SKIP_CAP4") != "1":
        c4_ms, c4_dropped = measure(step_fn(params, cam_t, CAP_MULT * N_GAUSSIANS,
                                            CAP4_CHUNK, CAP4_TILE, dev))
        c4_pix_ps = pix / (c4_ms / 1e3)
        result.update(cap4_pixels_per_s=c4_pix_ps,
                      cap4_entries_dropped=c4_dropped, cap4_cap_mult=CAP_MULT,
                      cap4_tile=list(CAP4_TILE), cap4_chunk=CAP4_CHUNK, cap4_ms_per_step=c4_ms)
    result["device"] = smi_line()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
