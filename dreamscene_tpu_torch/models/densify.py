"""Densification statistics, torch (the part of
dreamscene_tpu/models/densify.py that the FPS step updates).

densify_and_prune, reset_opacity and the prune helpers are not ported
yet (ROADMAP queue A, slice 2); the trainer raises where it would call
them.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def add_densification_stats(aux: dict, means2d_grad: torch.Tensor,
                            update_filter: torch.Tensor) -> dict:
    """Accumulate screen-space mean gradient norms (reference:
    gs_renderer.py:1061-1066)."""
    norm = torch.linalg.norm(means2d_grad[:, :2], dim=-1)
    f = update_filter.float()
    return dict(aux, xyz_gradient_accum=aux["xyz_gradient_accum"] + norm * f,
                denom=aux["denom"] + f)


@torch.no_grad()
def update_max_radii(aux: dict, radii: torch.Tensor, visible: torch.Tensor) -> dict:
    return dict(aux, max_radii2d=torch.where(
        visible, torch.maximum(aux["max_radii2d"], radii.float()), aux["max_radii2d"]))
