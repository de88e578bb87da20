"""The outdoor scene's env shell and floor disk at their initialization, in
plain numpy and PyTorch: the benchmark's reference of `prepare_train_scene`'s
env and floor (DreamScene's gs_renderer.py, `cam_pose_method: outdoor`).

The scene box is the configuration's (`radius` as half-extents; with
`zero_ground` the ground at z = 0), the placed objects lying inside it. Its
circumscribed radius R sets the counts, ceil(50,000 R density) env points
and ceil(20,000 R density) floor points, and the shapes:

  env    numpy RandomState(seed): phi = 2 pi u, cos theta = u (the upper
         hemisphere with `zero_ground`, else 2u - 1), r = R cbrt(u / 10 +
         0.95), drawn as three arrays in that order;
  floor  RandomState(seed + 1): r = R sqrt(u), phi = 2 pi u, z = u / 10 -
         0.1 + the box's lowest z.

Each point's initial log-scale is log(sqrt(max(d, 1e-7))), d the mean
squared distance to its 3 nearest other points of the same model, found by
exact blocked search over every point on the device in float64.

`lower=True` rounds the positions to bfloat16 before the search and the
comparison, the precision below the float32 the program keeps them in.
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ENV_PER_R = 50_000
FLOOR_PER_R = 20_000


def scene_box(radius, zero_ground: bool) -> np.ndarray:
    """[min xyz, max xyz] of the configured box."""
    r = np.asarray(radius, np.float64)
    lo = np.array([-r[0], -r[1], 0.0 if zero_ground else -r[2]])
    return np.concatenate([lo, r])


def circumradius(box: np.ndarray) -> float:
    return float(np.sqrt(np.sum(np.maximum(np.abs(box[:3]), np.abs(box[3:])) ** 2)))


def env_points(box: np.ndarray, seed: int, density: float, zero_ground: bool) -> np.ndarray:
    rng = np.random.RandomState(seed)
    big_r = circumradius(box)
    n = int(np.ceil(big_r * ENV_PER_R * density))
    phi = rng.random(n) * 2 * np.pi
    cos_t = rng.random(n) if zero_ground else rng.random(n) * 2 - 1
    r = big_r * np.cbrt(rng.random(n) / 10 + 0.95)
    theta = np.arccos(cos_t)
    return np.stack([r * np.sin(theta) * np.cos(phi), r * np.sin(theta) * np.sin(phi),
                     r * np.cos(theta)], axis=1)


def floor_points(box: np.ndarray, seed: int, density: float) -> np.ndarray:
    rng = np.random.RandomState(seed + 1)
    big_r = circumradius(box)
    n = int(np.ceil(big_r * FLOOR_PER_R * density))
    r = big_r * np.sqrt(rng.random(n))
    phi = rng.random(n) * 2 * np.pi
    z = rng.random(n) / 10.0 - 0.1 + box[2]
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


def knn_log_scales(points: torch.Tensor, rows: torch.Tensor, block: int = 128) -> torch.Tensor:
    """log(sqrt(max(mean squared distance to the 3 nearest other points,
    1e-7))) of points[rows], searched over every point (float64)."""
    p = points.double()
    out = []
    for i in range(0, rows.numel(), block):
        idx = rows[i:i + block]
        q = p[idx]
        d2 = torch.zeros((idx.numel(), p.shape[0]), dtype=torch.float64, device=p.device)
        for c in range(3):
            d2 += (q[:, c, None] - p[None, :, c]) ** 2
        d2[torch.arange(idx.numel(), device=p.device), idx] = float("inf")
        out.append(d2.topk(3, dim=1, largest=False).values.mean(1))
    return torch.log(torch.sqrt(torch.cat(out).clamp_min(1e-7)))


def outdoor_init(radius, zero_ground: bool, seed: int, density: float, samples: dict,
                 device, lower: bool = False) -> dict:
    """{"floor" | "env": {"xyz": [n, 3] float64, "log_scale": [k] at the
    rows `samples[name]`}}, and "radius", the box's circumradius."""
    box = scene_box(radius, zero_ground)
    out = {"radius": circumradius(box)}
    for name, pts in (("floor", floor_points(box, seed, density)),
                      ("env", env_points(box, seed, density, zero_ground))):
        xyz = torch.as_tensor(pts.astype(np.float32), device=device)
        if lower:
            xyz = xyz.to(torch.bfloat16).float()
        rows = samples[name].to(device)
        out[name] = {"xyz": xyz.double(), "log_scale": knn_log_scales(xyz, rows)}
    return out
