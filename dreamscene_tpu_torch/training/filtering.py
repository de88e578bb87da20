"""Importance-based splat filtering (port of
dreamscene_tpu/training/filtering.py; reference scene_gaussian.py:1046-1103
`gaussian_filtering`).

Importance of a splat = its blend weight (T*alpha summed over pixels)
summed over 48 sphere-sampled views, read as the colour-probe gradient
through K2 (`rendering.score_render`). The prune keeps the top
(1 - prune_decay*prune_percent) quantile of volume^v_pow * importance.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from dreamscene_tpu_torch.cameras import sampling as S
from dreamscene_tpu_torch.models import densify as D
from dreamscene_tpu_torch.models.gaussians import GaussianState, num_active
from dreamscene_tpu_torch.rendering import score_render

logger = logging.getLogger("dreamscene_tpu_torch")


@torch.no_grad()
def importance_filter(state: GaussianState, rng: np.random.Generator, pose_args,
                      bg_color=(0.0, 0.0, 0.0), prune_percent: float = 0.5,
                      v_pow: float = 0.1, prune_decay: float = 0.8,
                      n_views: int = 48) -> GaussianState:
    """Score splats over sphere cameras and prune the least important
    fraction (v_list = (volume / 90th-percentile volume)^v_pow *
    accumulated blend weight)."""
    cams = S.load_sphere_cam(rng, pose_args, size=n_views)
    imp = torch.zeros((state.capacity,), device=state.device)
    for cam in cams:
        imp = imp + score_render(state, cam, bg_color=bg_color)["important_score"]
    volume = torch.prod(state.get_scaling, dim=1) * state.aux["active"]
    n_act = num_active(state)
    sorted_volume = torch.sort(volume, descending=True).values
    kth = sorted_volume[min(int(0.9 * n_act), state.capacity - 1)]
    v_list = torch.pow(volume / torch.clamp_min(kth, 1e-12), v_pow) * imp
    new_state = D.prune_by_importance(state, prune_decay * prune_percent, v_list)
    logger.debug("importance_filter: %d -> %d", n_act, num_active(new_state))
    return new_state
