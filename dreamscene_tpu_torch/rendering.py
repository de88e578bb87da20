"""Render entry points for test-time views: object_render, score_render,
scene_render, plus the host-sampled train-time augmentation draws.

Port of dreamscene_tpu/rendering.py (reference SceneGaussian render
wrappers, scene_gaussian.py:546-671, 673-893, 895-1044):
  * activations -> rasterizer inputs (exp / sigmoid / normalize);
  * `sample_aug` draws the augmentations (SH-degree drop, background, SH
    noise, scale noise; scene_gaussian.py:723-732, 850-857) in the JAX
    package's order. The training steps apply them in their per-camera
    render (parallel/sharded_render.py::make_fps_camera_render); the
    renders here take none;
  * depth -> normalized disparity (scene_gaussian.py:871-881);
  * multi-model concatenation (`concat_states`, `scene_render`) with the
    segment offsets that slice per-model arrays back out
    (`split_by_segments`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dreamscene_tpu_torch.cameras.camera import Camera
from dreamscene_tpu_torch.models.gaussians import GaussianState
from dreamscene_tpu_torch.ops import rasterizer as R


@dataclasses.dataclass(frozen=True)
class RenderAug:
    """Resolved per-call augmentation (host-sampled)."""

    sh_degree_drop: bool = False
    bg_color: tuple = (1.0, 1.0, 1.0)
    shs_noise: float = 0.0
    scale_noise: float = 0.0
    seed: int = 0


def sample_aug(rng: np.random.Generator, model_args, bg_color) -> RenderAug:
    """The reference's train-time augmentations (scene_gaussian.py:723-732,
    850-857), drawn in the JAX package's order from the same generator."""
    sh_drop = rng.random() < model_args.sh_deg_aug_ratio
    bg = tuple(bg_color)
    if rng.random() < model_args.bg_aug_ratio:
        if rng.random() < 0.5:
            bg = tuple(rng.random(3).tolist())
        else:
            bg = (0.0, 0.0, 0.0)
    shs_noise = 1.0 if rng.random() < model_args.shs_aug_ratio else 0.0
    scale_noise = 1.0 if rng.random() < model_args.scale_aug_ratio else 0.0
    return RenderAug(sh_degree_drop=sh_drop, bg_color=bg, shs_noise=shs_noise,
                     scale_noise=scale_noise, seed=int(rng.integers(0, 2**31)))


def camera_arrays(camera: Camera, device) -> dict:
    return dict(viewmatrix=torch.as_tensor(camera.world_view_transform, device=device),
                projmatrix=torch.as_tensor(camera.full_proj_transform, device=device),
                campos=torch.as_tensor(camera.camera_center, device=device),
                tanfovx=camera.tanfovx, tanfovy=camera.tanfovy, width=camera.width,
                height=camera.height)


def _clip(x, lo: float, hi: float):
    """jnp.clip as min(max(x, lo), hi): ties at the bounds split the
    gradient like the JAX package's, which torch.clamp does not."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def normalized_disparity(raw_depth, alpha, tanfovx: float):
    """depth + alpha -> normalized disparity in [0, 1] (reference
    scene_gaussian.py:871-881): disp = focal / (depth + 10*alpha + 1e-5),
    min over the empty (alpha <= 0.1) region, with the JAX package's 0/0
    guard on the denominator (an exactly empty view gives max == min)."""
    focal = 1.0 / (2.0 * tanfovx)
    disp = focal / (raw_depth + alpha * 10.0 + 1e-5)
    empty = alpha <= 0.1
    min_d = torch.where(empty.any(),
                        torch.where(empty, disp, torch.full_like(disp, float("inf"))).min(),
                        disp.min())
    return _clip((disp - min_d) / torch.clamp_min(disp.max() - min_d, 1e-12), 0.0, 1.0)


def _postprocess(out: dict, camera: Camera) -> dict:
    """The raw depth kept as "raw_depth", the normalized disparity
    returned as "depth", like the reference."""
    out["raw_depth"] = out["depth"]
    out["depth"] = normalized_disparity(out["depth"], out["alpha"], camera.tanfovx)
    return out


def prepare_inputs(state: GaussianState) -> dict:
    """Activations -> rasterizer inputs."""
    return dict(means3d=state.get_xyz, scales=state.get_scaling, quats=state.get_rotation,
                opacities=state.get_opacity[:, 0], shs=state.get_features,
                valid_mask=state.aux["active"])


def object_render(state: GaussianState, camera: Camera, bg_color=(0.0, 0.0, 0.0)) -> dict:
    """Single-model render on the state's device (reference
    object_render, scene_gaussian.py:895-1044) at 4 entries a row."""
    out = R.render(**prepare_inputs(state), **camera_arrays(camera, state.device),
                   bg=torch.tensor(bg_color, dtype=torch.float32, device=state.device),
                   sh_degree=state.active_sh_degree, capacity=4 * state.capacity,
                   device=state.device)
    return _postprocess(out, camera)


def score_render(state: GaussianState, camera: Camera, bg_color=(0.0, 0.0, 0.0)) -> dict:
    """Render + per-splat importance (reference score_render,
    scene_gaussian.py:546-671) at 4 entries a row."""
    out = R.score_render(**prepare_inputs(state), **camera_arrays(camera, state.device),
                         bg=torch.tensor(bg_color, dtype=torch.float32, device=state.device),
                         sh_degree=state.active_sh_degree, capacity=4 * state.capacity,
                         device=state.device)
    return _postprocess(out, camera)


def concat_states(states):
    """Concatenate models for one joint render: (rasterizer inputs,
    segment offsets); segment i covers state i's capacity rows. SH is
    zero-padded to the highest degree."""
    k = max(s.params["features_rest"].shape[1] for s in states) + 1
    parts = []
    for s in states:
        p = prepare_inputs(s)
        if p["shs"].shape[1] < k:
            p["shs"] = torch.cat([p["shs"], p["shs"].new_zeros(
                (p["shs"].shape[0], k - p["shs"].shape[1], 3))], dim=1)
        parts.append(p)
    offsets = np.cumsum([0] + [s.capacity for s in states])
    return {key: torch.cat([p[key] for p in parts], dim=0) for key in parts[0]}, offsets


def scene_render(states, camera: Camera, bg_color=(0.0, 0.0, 0.0),
                 capacity: int | None = None) -> dict:
    """Joint multi-model render on the states' device (reference
    scene_render, scene_gaussian.py:673-893): the visible models
    concatenated, one rasterizer pass; SH degree = the lowest active degree
    of the models; default entry capacity max(4 * total rows, 2048)."""
    dev = states[0].device
    inputs, offsets = concat_states(states)
    if capacity is None:
        capacity = max(4 * int(offsets[-1]), 2048)
    out = R.render(**inputs, **camera_arrays(camera, dev),
                   bg=torch.as_tensor(bg_color, dtype=torch.float32, device=dev).reshape(3),
                   sh_degree=min(s.active_sh_degree for s in states), capacity=capacity,
                   device=dev)
    out = _postprocess(out, camera)
    out["segments"] = offsets
    return out


def split_by_segments(arr, offsets) -> list:
    """Slice a concatenated per-splat array back into per-model arrays."""
    return [arr[int(offsets[i]):int(offsets[i + 1])] for i in range(len(offsets) - 1)]
