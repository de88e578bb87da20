"""Render entry points: object_render, score_render, scene_render, plus
the host-sampled train-time augmentations.

Port of dreamscene_tpu/rendering.py (reference SceneGaussian render
wrappers, scene_gaussian.py:546-671, 673-893, 895-1044):
  * activations -> rasterizer inputs (exp / sigmoid / normalize);
  * augmentations: SH-degree drop, background, SH noise, scale noise
    (scene_gaussian.py:723-732, 850-857). The noise enters as explicit
    standard-normal tensors (`shs_noise` [C,K,3], `scale_noise` [C,3]),
    as in `fps_step`, where the JAX package draws it from a key;
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


def sample_aug(rng: np.random.Generator, model_args, bg_color=(0.0, 0.0, 0.0),
               test: bool = False) -> RenderAug:
    """The reference's train-time augmentations (scene_gaussian.py:723-732,
    850-857), drawn in the JAX package's order from the same generator."""
    if test:
        return RenderAug(bg_color=tuple(bg_color))
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


def prepare_inputs(state: GaussianState, aug: RenderAug | None = None, shs_noise=None,
                   scale_noise=None) -> dict:
    """Activations + augmentation noise -> rasterizer inputs (noise
    semantics: scene_gaussian.py:850-857)."""
    shs = state.get_features
    scales = state.get_scaling
    if aug is not None and aug.shs_noise > 0:
        if shs_noise is None:
            raise ValueError("aug.shs_noise > 0 needs the shs_noise tensor")
        shs = shs + shs_noise * (0.2**0.5) * shs
    if aug is not None and aug.scale_noise > 0:
        if scale_noise is None:
            raise ValueError("aug.scale_noise > 0 needs the scale_noise tensor")
        scales = torch.clamp_min(scales + scale_noise * (0.2**0.5) * scales / 4, 0.0)
    return dict(means3d=state.get_xyz, scales=scales, quats=state.get_rotation,
                opacities=state.get_opacity[:, 0], shs=shs, valid_mask=state.aux["active"])


def object_render(state: GaussianState, camera: Camera, bg_color=None,
                  aug: RenderAug | None = None, test: bool = False, means2d_probe=None,
                  capacity_mult: int = 4, shs_noise=None, scale_noise=None) -> dict:
    """Single-model render on the state's device (reference
    object_render, scene_gaussian.py:895-1044)."""
    inputs = prepare_inputs(state, None if test else aug, shs_noise, scale_noise)
    sh_degree = 0 if (aug and aug.sh_degree_drop and not test) else state.active_sh_degree
    bg = bg_color if bg_color is not None else (aug.bg_color if aug else (0, 0, 0))
    out = R.render(**inputs, **camera_arrays(camera, state.device),
                   bg=torch.tensor(bg, dtype=torch.float32, device=state.device),
                   sh_degree=sh_degree, capacity=capacity_mult * state.capacity,
                   means2d_probe=means2d_probe, device=state.device)
    return _postprocess(out, camera)


def score_render(state: GaussianState, camera: Camera, bg_color=(0.0, 0.0, 0.0),
                 capacity_mult: int = 4) -> dict:
    """Render + per-splat importance (reference score_render,
    scene_gaussian.py:546-671)."""
    out = R.score_render(**prepare_inputs(state), **camera_arrays(camera, state.device),
                         bg=torch.tensor(bg_color, dtype=torch.float32, device=state.device),
                         sh_degree=state.active_sh_degree,
                         capacity=capacity_mult * state.capacity, device=state.device)
    return _postprocess(out, camera)


def concat_states(states, shs_noise=None, scale_noise=None, aug: RenderAug | None = None):
    """Concatenate models for one joint render: (rasterizer inputs,
    segment offsets); segment i covers state i's capacity rows. SH is
    zero-padded to the highest degree. Augmentation noise, when given,
    applies to the concatenated arrays."""
    k = max(s.params["features_rest"].shape[1] for s in states) + 1
    parts = []
    for s in states:
        p = prepare_inputs(s)
        if p["shs"].shape[1] < k:
            p["shs"] = torch.cat([p["shs"], p["shs"].new_zeros(
                (p["shs"].shape[0], k - p["shs"].shape[1], 3))], dim=1)
        parts.append(p)
    offsets = np.cumsum([0] + [s.capacity for s in states])
    cat = {key: torch.cat([p[key] for p in parts], dim=0) for key in parts[0]}
    if aug is not None and aug.shs_noise > 0:
        if shs_noise is None:
            raise ValueError("aug.shs_noise > 0 needs the shs_noise tensor")
        cat["shs"] = cat["shs"] + shs_noise * (0.2**0.5) * cat["shs"]
    if aug is not None and aug.scale_noise > 0:
        if scale_noise is None:
            raise ValueError("aug.scale_noise > 0 needs the scale_noise tensor")
        cat["scales"] = torch.clamp_min(
            cat["scales"] + scale_noise * (0.2**0.5) * cat["scales"] / 4, 0.0)
    return cat, offsets


def scene_render(states, camera: Camera, bg_color=None, aug: RenderAug | None = None,
                 test: bool = False, means2d_probe=None, capacity: int | None = None,
                 shs_noise=None, scale_noise=None) -> dict:
    """Joint multi-model render on the states' device (reference
    scene_render, scene_gaussian.py:673-893): the visible models
    concatenated, one rasterizer pass; SH degree = the lowest active degree
    of the models; default entry capacity max(4 * total rows, 2048)."""
    dev = states[0].device
    inputs, offsets = concat_states(states, shs_noise, scale_noise, None if test else aug)
    sh_degree = min(s.active_sh_degree for s in states)
    if aug and aug.sh_degree_drop and not test:
        sh_degree = 0
    bg = bg_color if bg_color is not None else (aug.bg_color if aug else (0, 0, 0))
    n_total = int(offsets[-1])
    if capacity is None:
        capacity = max(4 * n_total, 2048)
    out = R.render(**inputs, **camera_arrays(camera, dev),
                   bg=torch.as_tensor(bg, dtype=torch.float32, device=dev).reshape(3),
                   sh_degree=sh_degree, capacity=capacity, means2d_probe=means2d_probe,
                   device=dev)
    out = _postprocess(out, camera)
    out["segments"] = offsets
    return out


def split_by_segments(arr, offsets) -> list:
    """Slice a concatenated per-splat array back into per-model arrays."""
    return [arr[int(offsets[i]):int(offsets[i + 1])] for i in range(len(offsets) - 1)]
