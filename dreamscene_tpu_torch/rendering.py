"""Render augmentations (the part of dreamscene_tpu/rendering.py that the
object FPS step uses): host-sampled per-camera augmentation flags.

object_render, scene_render and score_render are not ported yet
(ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses

import numpy as np


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
