"""Differentiable 3D Gaussian splat rasterizer — public API, torch.

Port of dreamscene_tpu/ops/rasterizer.py:

  render(...) -> {image [3,H,W], depth [H,W], alpha [H,W], t_final [H,W],
                  radii [N], visibility_filter [N], n_dropped, n_entries}

Pipeline: project (autograd) -> bin (integer plumbing, no grad) ->
`GatherComposite` (record gather + K1, which also leaves the per-chunk
carry table for K2; its backward runs K2 and reduces the per-entry grad
table back to splats) -> image assembly (autograd).
The screen-space mean gradient for densification comes through the
zero-valued `means2d_probe` input, as in the JAX package; `score_render`
takes each splat's importance as the gradient of a zero colour probe.
"""

from __future__ import annotations

import torch

from dreamscene_tpu_torch.device import resolve_device
from dreamscene_tpu_torch.ops.binning import bin_splats, cdiv, resolve_tile
from dreamscene_tpu_torch.ops.composite import (
    ACC_ROWS,
    N_LIVE_FIELDS,
    REC_WIDTH,
    composite_backward,
    composite_forward_carry,
)
from dreamscene_tpu_torch.ops.projection import project_gaussians


def blocked_cumsum(x: torch.Tensor, block: int = 128) -> torch.Tensor:
    """Inclusive cumsum over axis 0, two-level blocked: an in-block cumsum
    plus a recursively blocked carry. A flat fp32 cumsum over ~240K rows
    loses precision; the blocked form keeps each partial sum short (the
    JAX package's `_blocked_cumsum`)."""
    m, w = x.shape
    if m <= block:
        return torch.cumsum(x, dim=0)
    nb = cdiv(m, block)
    xp = torch.cat([x, x.new_zeros((nb * block - m, w))], dim=0)
    inner = torch.cumsum(xp.reshape(nb, block, w), dim=1)
    carry = blocked_cumsum(inner[:, -1, :], block)
    carry = torch.cat([x.new_zeros((1, w)), carry[:-1]], dim=0)
    return (inner + carry[:, None, :]).reshape(nb * block, w)[:m]


class GatherComposite(torch.autograd.Function):
    """Record gather + K1 under one autograd node: the chunk-aligned grad
    table is an internal layout that never leaves this function.

    Backward: K2 writes per-entry gradients; entries are gathered into
    expansion order through `pos_of_entry` (masked entries redirected to
    the zeroed chunk n_chunks_used), each rank's contiguous segment is
    reduced with a blocked cumsum difference, and the depth permutation is
    undone with one gather."""

    @staticmethod
    def forward(ctx, rec_n, inv_perm, gid_pad, pos_of_entry, surv, seg_starts,
                chunk_tile, chunk_s0, chunk_lo, chunk_hi, chunk_first,
                n_chunks_used, n_tiles, tiles_x, chunk, tile_w, tile_h):
        records_t = rec_n.index_select(0, gid_pad.long()).t().contiguous()
        meta = (chunk_tile, chunk_s0, chunk_lo, chunk_hi, chunk_first, n_chunks_used)
        out, carry = composite_forward_carry(records_t, *meta, n_tiles=n_tiles,
                                             tiles_x=tiles_x, chunk=chunk, tile_w=tile_w,
                                             tile_h=tile_h)
        ctx.save_for_backward(records_t, out, carry, inv_perm, pos_of_entry, surv,
                              seg_starts, *meta)
        ctx.static = (n_tiles, tiles_x, chunk, tile_w, tile_h)
        return out

    @staticmethod
    def backward(ctx, g_out):
        (records_t, out, carry, inv_perm, pos_of_entry, surv, seg_starts,
         *meta) = ctx.saved_tensors
        n_tiles, tiles_x, chunk, tile_w, tile_h = ctx.static
        grec_t = composite_backward(
            records_t, *meta, out, g_out.contiguous(), n_tiles=n_tiles,
            tiles_x=tiles_x, chunk=chunk, tile_w=tile_w, tile_h=tile_h, carry=carry)
        capacity = pos_of_entry.shape[0]
        u_used = meta[-1]
        n_live = surv.sum()
        e = torch.arange(capacity, dtype=torch.int32, device=grec_t.device)
        keep = (e < n_live) & (pos_of_entry < u_used * chunk)
        pos_safe = torch.where(keep, pos_of_entry, u_used * chunk).long()
        g10 = grec_t[:N_LIVE_FIELDS].t()                   # [cols, 10] view
        csum = blocked_cumsum(g10[pos_safe], 128)
        bidx = torch.clamp(seg_starts - 1, 0, capacity - 1).long()
        bot = torch.where((seg_starts > 0)[:, None], csum[bidx],
                          torch.zeros((), device=csum.device))
        top = torch.cat([bot[1:], csum[-1:]], dim=0)
        grad_rank = top - bot
        grad_n = grad_rank[inv_perm.long()]
        grad_n = torch.cat(
            [grad_n, grad_n.new_zeros((grad_n.shape[0], REC_WIDTH - N_LIVE_FIELDS))],
            dim=1)
        return (grad_n,) + (None,) * 16


def render(means3d, scales, quats, opacities, shs, viewmatrix, projmatrix,
           campos, tanfovx, tanfovy, width: int, height: int, bg,
           sh_degree: int = 3, scale_modifier: float = 1.0,
           capacity: int | None = None, chunk: int = 512, valid_mask=None,
           colors_precomp=None, cov3d_precomp=None, means2d_probe=None,
           colors_probe=None, tile_w: int | None = None,
           tile_h: int | None = None, device: str | torch.device = "cuda") -> dict:
    """Render N Gaussians to an RGB+depth+alpha image. `device` names
    where the tensors must lie ("cuda" by default; pass "cpu" to run the
    plain versions): a CUDA request raises when CUDA is missing."""
    dev = resolve_device(device)
    if means3d.device.type != dev.type:
        raise ValueError(f"inputs lie on {means3d.device}, render asked for {dev}")
    n = means3d.shape[0]
    if capacity is None:
        capacity = max(4 * n, 2048)
    splats = project_gaussians(
        means3d, scales, quats, opacities, shs, viewmatrix, projmatrix,
        campos, tanfovx, tanfovy, width, height, sh_degree=sh_degree,
        scale_modifier=scale_modifier, colors_precomp=colors_precomp,
        cov3d_precomp=cov3d_precomp, valid_mask=valid_mask)
    means2d = splats.means2d
    if means2d_probe is not None:
        means2d = means2d + means2d_probe
    colors = splats.colors
    if colors_probe is not None:
        colors = colors + colors_probe
    splats = splats._replace(means2d=means2d, colors=colors)
    return render_from_splats(splats, width, height, bg, capacity=capacity,
                              chunk=chunk, tile_w=tile_w, tile_h=tile_h)


def render_from_splats(splats, width: int, height: int, bg, capacity: int,
                       chunk: int = 512, tile_w: int | None = None,
                       tile_h: int | None = None) -> dict:
    """Rasterize already-projected splats (probes applied)."""
    n = splats.means2d.shape[0]
    dev = splats.means2d.device
    tile_w, tile_h = resolve_tile(tile_w, tile_h)
    tiles_x = cdiv(width, tile_w)
    tiles_y = cdiv(height, tile_h)
    n_tiles = tiles_x * tiles_y
    means2d = splats.means2d

    binned = bin_splats(
        means2d, splats.depths, splats.radii, splats.visible, width, height,
        capacity=capacity, chunk=chunk, conics=splats.conics.detach(),
        opacities=splats.opacities.detach(), tile_w=tile_w, tile_h=tile_h)

    rec_n = torch.cat(
        [means2d, splats.conics, splats.opacities[:, None], splats.colors,
         splats.depths[:, None],
         means2d.new_zeros((n, REC_WIDTH - N_LIVE_FIELDS))], dim=1).float()
    cap_pad = cdiv(capacity, 128) * 128 + chunk
    gid_pad = torch.cat([binned.gid_sorted,
                         torch.zeros((cap_pad - capacity,), dtype=torch.int32, device=dev)])
    tiles_out = GatherComposite.apply(
        rec_n, binned.inv_perm, gid_pad, binned.pos_of_entry,
        binned.surv_counts, binned.seg_starts, binned.chunk_tile,
        binned.chunk_s0, binned.chunk_lo, binned.chunk_hi, binned.chunk_first,
        binned.n_chunks_used, n_tiles, tiles_x, chunk, tile_w, tile_h)

    body = tiles_out[:n_tiles].reshape(tiles_y, tiles_x, ACC_ROWS, tile_h, tile_w)
    full = body.permute(2, 0, 3, 1, 4).reshape(
        ACC_ROWS, tiles_y * tile_h, tiles_x * tile_w)[:, :height, :width]
    rgb_acc = full[0:3]
    depth_acc = full[3]
    t_final = full[4]
    image = rgb_acc + t_final[None] * bg[:, None, None]
    return {
        "image": image,
        "depth": depth_acc,
        "alpha": 1.0 - t_final,
        "t_final": t_final,
        "radii": splats.radii,
        "visibility_filter": splats.visible,
        "n_dropped": binned.n_dropped,
        "n_entries": binned.n_entries,
    }


def score_render(**kwargs) -> dict:
    """`render` plus per-splat importance (the comp- rasterizer's
    score_flag variant): important_score[g] = sum over pixels of the
    splat's blend weight T*alpha, the gradient of sum(accumulated red)
    with respect to a zero post-clamp colour probe, through K2."""
    n = kwargs["means3d"].shape[0]
    probe = torch.zeros((n, 3), device=kwargs["means3d"].device, requires_grad=True)
    with torch.enable_grad():
        out = render(**kwargs, colors_probe=probe)
        # pre-background accumulated rgb = image - T*bg
        rgb_acc = out["image"] - out["t_final"][None] * kwargs["bg"][:, None, None]
        (g,) = torch.autograd.grad(rgb_acc[0].sum(), probe)
    out = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in out.items()}
    out["important_score"] = g[:, 0]
    return out
