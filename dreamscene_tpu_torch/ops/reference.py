"""Slow, exact, autodiffable golden renderer (torch autograd).

Port of dreamscene_tpu/ops/reference.py: every projected splat is
composited against every pixel in depth order, with the CUDA rasterizer's
per-pixel semantics (alpha = min(0.99, opa*exp(power)), skipped when
power > 0 or alpha < 1/255, tile-rect cut, a splat that would take T
below 1e-4 is not composited and ends the pixel). O(N*H*W): tests only.
"""

from __future__ import annotations

import torch

from dreamscene_tpu_torch.ops.projection import ProjectedSplats, project_gaussians

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
TRANSMITTANCE_EPS = 1e-4


def composite_reference(splats: ProjectedSplats, width: int, height: int, bg,
                        tile_w: int = 32, tile_h: int = 16) -> dict:
    n = splats.means2d.shape[0]
    dev = splats.means2d.device
    key = torch.where(splats.visible, splats.depths.detach(),
                      torch.full_like(splats.depths, float("inf")))
    order = torch.sort(key, stable=True).indices
    opac = torch.where(splats.visible, splats.opacities,
                       torch.zeros_like(splats.opacities))

    px = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    py = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    tx_pix = torch.floor(px / tile_w)
    ty_pix = torch.floor(py / tile_h)

    rgb = torch.zeros((3, height, width), device=dev)
    depth_acc = torch.zeros((height, width), device=dev)
    t = torch.ones((height, width), device=dev)
    scores = []
    for i in order.tolist():
        mean = splats.means2d[i]
        conic = splats.conics[i]
        radius = splats.radii[i].float()
        dx = mean[0] - px
        dy = mean[1] - py
        mx, my = mean[0].detach(), mean[1].detach()
        x0 = torch.floor((mx - radius) / tile_w)
        y0 = torch.floor((my - radius) / tile_h)
        x1 = torch.floor((mx + radius + tile_w - 1) / tile_w)
        y1 = torch.floor((my + radius + tile_h - 1) / tile_h)
        in_rect = (tx_pix >= x0) & (tx_pix < x1) & (ty_pix >= y0) & (ty_pix < y1)
        power = -0.5 * (conic[0] * dx * dx + conic[2] * dy * dy) - conic[1] * dx * dy
        alpha = torch.clamp_max(opac[i] * torch.exp(power), ALPHA_MAX)
        zero = torch.zeros_like(alpha)
        alpha = torch.where(power > 0.0, zero, alpha)
        alpha = torch.where(alpha < ALPHA_MIN, zero, alpha)
        alpha = torch.where(in_rect, alpha, zero)
        t_test = t * (1.0 - alpha)
        alpha = torch.where(t_test < TRANSMITTANCE_EPS, zero, alpha)
        w = t * alpha
        rgb = rgb + w[None] * splats.colors[i][:, None, None]
        depth_acc = depth_acc + w * splats.depths[i]
        t = t * (1.0 - alpha)
        scores.append(w.sum())
    image = rgb + t[None] * bg[:, None, None]
    important = torch.zeros((n,), device=dev)
    if scores:
        important = important.index_put((order,), torch.stack(scores))
    return {"image": image, "depth": depth_acc, "alpha": 1.0 - t,
            "t_final": t, "important_score": important}


def render_reference(means3d, scales, quats, opacities, shs, viewmatrix,
                     projmatrix, campos, tanfovx, tanfovy, width, height, bg,
                     sh_degree=3, scale_modifier=1.0, valid_mask=None,
                     colors_precomp=None, tile_w=32, tile_h=16):
    """Full golden render path: projection + reference composite."""
    splats = project_gaussians(
        means3d, scales, quats, opacities, shs, viewmatrix, projmatrix,
        campos, tanfovx, tanfovy, width, height, sh_degree=sh_degree,
        scale_modifier=scale_modifier, valid_mask=valid_mask,
        colors_precomp=colors_precomp,
    )
    out = composite_reference(splats, width, height, bg, tile_w=tile_w, tile_h=tile_h)
    out["radii"] = splats.radii
    return out
