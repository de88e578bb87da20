"""Densification and pruning as masked, fixed-capacity tensor ops, torch.

Port of dreamscene_tpu/models/densify.py (reference:
gs_renderer.py:854-1103). No tensor resizing: selected splats are
cloned/split into free capacity slots by row scatters, pruning clears the
active mask, and Adam moments are zeroed row-wise:
  * clone: grad-norm >= threshold and max scale <= percent_dense * extent;
  * split (N=2): grad-norm >= threshold and max scale > percent_dense *
    extent; children sampled inside the parent (eps ~ N(0,1) [C,2,3] is
    an argument, so a caller can hand in any draw), scales shrunk by
    1/(0.8*2), child A overwrites the parent, child B takes a free slot;
  * prune: opacity < min_opacity, world scale > 0.1 * extent;
  * opacity reset to <= 0.01 with zeroed opacity moments;
  * importance prune of the bottom percentile.
New splats that do not fit the capacity are dropped (the trainer grows
the capacity between densifications, as the JAX trainer does).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dreamscene_tpu_torch.models.gaussians import AdamState, GaussianState, inverse_sigmoid
from dreamscene_tpu_torch.ops.covariance import build_rotation


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


def _alloc_free_slots(active: torch.Tensor, sel: torch.Tensor, offset=0):
    """Destination free slot for each selected row (its rank among the
    selected rows, after `offset` reserved slots). Returns (dest [C]
    int32, C where not placed; ok [C] bool)."""
    c = active.shape[0]
    free_order = torch.argsort(active.to(torch.int32), stable=True)   # free slots first
    rank = torch.cumsum(sel.to(torch.int64), 0) - 1 + offset
    ok = sel & (rank < (~active).sum())
    dest = torch.where(ok, free_order[rank.clamp(0, c - 1)], c)
    return dest.to(torch.int32), ok


def _scatter_rows(tree: dict, src: dict, dest: torch.Tensor, on: torch.Tensor) -> dict:
    """Copy row i of src to row dest[i] where on[i] (row tensors only)."""
    c = dest.shape[0]
    out = {}
    for k, x in tree.items():
        if x.dim() == 0 or x.shape[0] != c:
            out[k] = x
            continue
        x = x.clone()
        x[dest[on].long()] = src[k][on]
        out[k] = x
    return out


def _zero_rows(tree: dict, idx: torch.Tensor, on: torch.Tensor) -> dict:
    return _scatter_rows(tree, {k: torch.zeros_like(v) for k, v in tree.items()}, idx, on)


@torch.no_grad()
def densify_and_prune(state: GaussianState, eps: torch.Tensor, max_grad: float,
                      min_opacity: float, extent: float, max_screen_size: float | None,
                      percent_dense: float) -> GaussianState:
    """Clone, split and prune in one pass (reference
    gs_renderer.py:1034-1049); eps: standard-normal [C, 2, 3] draws for
    the split children."""
    params, aux, opt = state.params, state.aux, state.opt
    c = state.capacity
    active = aux["active"]
    grads = aux["xyz_gradient_accum"] / torch.clamp_min(aux["denom"], 1.0)
    grads = torch.where(aux["denom"] > 0, grads, torch.zeros_like(grads))
    scales = torch.exp(params["scaling"])
    max_scale = scales.amax(-1)
    hot = (grads >= max_grad) & active
    sel_clone = hot & (max_scale <= percent_dense * extent)
    sel_split = hot & (max_scale > percent_dense * extent)

    # clone: copy selected rows into free slots
    dest_c, ok_c = _alloc_free_slots(active, sel_clone)
    params = _scatter_rows(params, params, dest_c, ok_c)
    mu, nu = _zero_rows(opt.mu, dest_c, ok_c), _zero_rows(opt.nu, dest_c, ok_c)
    active = active.clone()
    active[dest_c[ok_c].long()] = True

    # split: child A overwrites the parent, child B takes a free slot
    # allocated after the clones
    dest_s, ok_s = _alloc_free_slots(aux["active"], sel_split, offset=ok_c.sum())
    offsets = torch.einsum("cij,cnj->cni", build_rotation(params["rotation"]),
                           eps * scales[:, None, :])
    child_xyz = params["xyz"][:, None, :] + offsets
    child_scaling = torch.log(scales / (0.8 * 2.0))
    child_a = dict(params, xyz=child_xyz[:, 0], scaling=child_scaling)
    child_b = dict(params, xyz=child_xyz[:, 1], scaling=child_scaling)
    idx = torch.arange(c, dtype=torch.int32, device=active.device)
    params = _scatter_rows(params, child_a, idx, sel_split)
    mu, nu = _zero_rows(mu, idx, sel_split), _zero_rows(nu, idx, sel_split)
    params = _scatter_rows(params, child_b, dest_s, ok_s)
    mu, nu = _zero_rows(mu, dest_s, ok_s), _zero_rows(nu, dest_s, ok_s)
    active[dest_s[ok_s].long()] = True

    # prune. The reference zeroes max_radii2D before this prune
    # (gs_renderer.py:968-970), so the screen-size test is inert here and
    # only the world-scale test applies (as in the JAX package)
    prune = torch.sigmoid(params["opacity"][:, 0]) < min_opacity
    if max_screen_size is not None:
        prune = prune | (torch.exp(params["scaling"]).amax(-1) > 0.1 * extent)
    zeros = torch.zeros((c,), device=active.device)
    new_aux = dict(active=active & ~prune, max_radii2d=zeros, xyz_gradient_accum=zeros.clone(),
                   denom=zeros.clone())
    return dataclasses.replace(state, params=params, aux=new_aux,
                               opt=AdamState(opt.count, mu, nu))


@torch.no_grad()
def prune_only(state: GaussianState, min_opacity: float, extent: float,
               max_screen_size: float | None) -> GaussianState:
    """reference: gs_renderer.py:1051-1059."""
    prune = torch.sigmoid(state.params["opacity"][:, 0]) < min_opacity
    if max_screen_size is not None:
        prune = prune | (state.aux["max_radii2d"] > max_screen_size)
        prune = prune | (torch.exp(state.params["scaling"]).amax(-1) > 0.1 * extent)
    return dataclasses.replace(state, aux=dict(state.aux, active=state.aux["active"] & ~prune))


@torch.no_grad()
def reset_opacity(state: GaussianState) -> GaussianState:
    """Clamp opacities to <= 0.01 and zero the opacity Adam moments
    (reference: gs_renderer.py:746-749)."""
    opac = torch.sigmoid(state.params["opacity"])
    new_logit = inverse_sigmoid(torch.clamp_max(opac, 0.01))
    opt = state.opt
    return dataclasses.replace(
        state, params=dict(state.params, opacity=new_logit),
        opt=AdamState(opt.count, dict(opt.mu, opacity=torch.zeros_like(opt.mu["opacity"])),
                      dict(opt.nu, opacity=torch.zeros_like(opt.nu["opacity"]))))


@torch.no_grad()
def prune_by_importance(state: GaussianState, percent: float,
                        important_score: torch.Tensor) -> GaussianState:
    """Drop the bottom `percent` of active splats by importance
    (reference: gs_renderer.py:1082-1087: threshold at the percent-th
    percentile, prune score <= threshold)."""
    active = state.aux["active"]
    n_active = int(active.sum())
    scores = torch.where(active, important_score, torch.full_like(important_score, float("inf")))
    sorted_scores = torch.sort(scores).values
    # float32 arithmetic, truncated, as the JAX package computes the index
    idx = int(np.float32(percent) * (np.float32(n_active) - np.float32(1.0)))
    threshold = sorted_scores[min(max(idx, 0), scores.shape[0] - 1)]
    prune = active & (important_score <= threshold)
    return dataclasses.replace(state, aux=dict(state.aux, active=active & ~prune))
