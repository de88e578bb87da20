"""Multi-rank sharded rendering and the sharded training step.

Port of dreamscene_tpu/parallel/sharded_render.py. The JAX package runs
one `jax.shard_map` over a ("dp", "tp") device mesh; here every rank runs
the function for its own coordinates (parallel/distributed.Mesh) and the
collectives are explicit (parallel/collectives.py):

  * cameras over "dp": the rank at (dp_i, tp_i) renders cameras
    [dp_i * b_local, (dp_i + 1) * b_local) of the batch;
  * tile bands over "tp": it projects against the full image, shifts
    screen y by tp_i * band_h and rasterizes its band (K3, K1, K2 at the
    band's shape);
  * with `shard_splats`, splats over "tp" too: the rank holds rows
    [tp_i * N / n_tp, (tp_i + 1) * N / n_tp), projects only those and
    all-gathers the compact projected records (12 floats a splat) across
    its tp group, in shard order, which is the single-device splat order.

The functions take this rank's part of the inputs (its cameras, its rows)
and return its part of the outputs (its cameras' bands, its rows). What a
`shard_map` does implicitly (the psum of gradients of replicated inputs)
the trainers do explicitly: see training/object_trainer.py::fps_step.

Departure: the JAX function draws each camera's SH/scale noise from a key
and, with `shard_splats`, folds the tp index into it; here the noise comes
in as tensors. The trainers draw the whole batch's noise on every rank
from the same generator and each rank takes its rows, so the sharded run
sees the unsharded run's noise.
"""

from __future__ import annotations

import dataclasses
import logging

import torch

from dreamscene_tpu_torch.models.gaussians import AdamState, GaussianState, adam_update
from dreamscene_tpu_torch.ops import binning
from dreamscene_tpu_torch.ops.projection import ProjectedSplats, project_gaussians
from dreamscene_tpu_torch.ops.rasterizer import render, render_from_splats
from dreamscene_tpu_torch.parallel import collectives as X
from dreamscene_tpu_torch.parallel.distributed import Mesh, rank, world_size
from dreamscene_tpu_torch.rendering import _clip

log = logging.getLogger(__name__)

# leaves that never shard, whatever their length (classified by name, as in
# the JAX package: a background [3] at capacity 3 must stay whole)
REPLICATED_FIELDS = frozenset({"background", "count"})


def make_mesh(n_dp: int, n_tp: int, ranks=None) -> Mesh:
    """("dp", "tp") mesh over every rank of the process group (or over
    `ranks`). The world must hold exactly n_dp * n_tp ranks."""
    if ranks is None and world_size() != n_dp * n_tp:
        raise ValueError(f"world size {world_size()} is not dp {n_dp} x tp {n_tp} "
                         f"= {n_dp * n_tp} ranks")
    return Mesh({"dp": n_dp, "tp": n_tp}, ranks)


def single_mesh() -> Mesh:
    """This process alone as a 1 x 1 mesh: no group, so every collective
    is the identity (the trainers' single-process steps)."""
    return Mesh({"dp": 1, "tp": 1}, [rank()])


def band_geometry(mesh: Mesh, height: int) -> tuple:
    """(band_h, this rank's first row). Bands are tile-aligned, so the
    per-tile cull matches the single-device render."""
    n_tp = mesh.shape["tp"]
    if height % n_tp:
        raise ValueError(f"height {height} does not split into {n_tp} bands")
    band_h = height // n_tp
    if band_h % binning.DEFAULT_TILE_H:
        raise ValueError(f"band of {band_h} rows is not a multiple of the "
                         f"{binning.DEFAULT_TILE_H}-row tile")
    return band_h, mesh.coords["tp"] * band_h


def gather_records(splats: ProjectedSplats, group) -> ProjectedSplats:
    """The tp group's projected splats, concatenated in shard order: one
    all-gather of [N_local, 12] floats (means2d, depth, conic, colour,
    opacity, radius, visibility) whose backward reduce-scatters the
    record gradients back to the owning shard."""
    if group is None:
        return splats
    rec = torch.cat([splats.means2d, splats.depths[:, None], splats.conics, splats.colors,
                     splats.opacities[:, None], splats.radii[:, None].float(),
                     splats.visible[:, None].float()], dim=1)
    g = X.all_gather(rec, group)
    return ProjectedSplats(means2d=g[:, 0:2], depths=g[:, 2], conics=g[:, 3:6],
                           colors=g[:, 6:9], opacities=g[:, 9],
                           radii=g[:, 10].detach().round().to(splats.radii.dtype),
                           visible=g[:, 11].detach() > 0.5)


def make_sharded_render(mesh: Mesh, width: int, height: int, sh_degree: int,
                        capacity: int, chunk: int = 256):
    """render_fn(inputs, cams, bg) -> (images [b,3,band_h,W], alphas
    [b,1,band_h,W]) for this rank's cameras `cams` (camera dicts) and
    backgrounds `bg` [b, 3]; `inputs` (rasterizer keywords: means3d,
    scales, quats, opacities, shs, optional valid_mask / means2d_probe)
    hold every splat."""
    band_h, band = band_geometry(mesh, height)

    def render_fn(inputs, cams, bg):
        images, alphas = [], []
        for i, cam in enumerate(cams):
            out = render(**inputs, **cam, width=width, height=band_h, bg=bg[i],
                         sh_degree=sh_degree, capacity=capacity, chunk=chunk,
                         pixel_offset_y=band, full_height=height,
                         device=inputs["means3d"].device)
            images.append(out["image"])
            alphas.append(out["alpha"][None])
        return torch.stack(images), torch.stack(alphas)

    return render_fn


def make_primitive_sharded_render(mesh: Mesh, width: int, height: int, sh_degree: int,
                                  capacity: int, chunk: int = 256):
    """As `make_sharded_render`, but `inputs` hold this rank's splat shard
    (rows [tp_i * N / n_tp, ...)): the rank projects its shard,
    all-gathers the records across its tp group and rasterizes its band."""
    band_h, band = band_geometry(mesh, height)
    group = mesh.group("tp")

    def render_fn(inputs, cams, bg):
        images, alphas = [], []
        for i, cam in enumerate(cams):
            splats = project_gaussians(
                inputs["means3d"], inputs["scales"], inputs["quats"], inputs["opacities"],
                inputs["shs"], cam["viewmatrix"], cam["projmatrix"], cam["campos"],
                cam["tanfovx"], cam["tanfovy"], width, height, sh_degree=sh_degree,
                valid_mask=inputs.get("valid_mask"))
            if inputs.get("means2d_probe") is not None:
                splats = splats._replace(means2d=splats.means2d + inputs["means2d_probe"])
            out = render_from_splats(gather_records(splats, group), width, band_h, bg[i],
                                     capacity=capacity, chunk=chunk, pixel_offset_y=band)
            images.append(out["image"])
            alphas.append(out["alpha"][None])
        return torch.stack(images), torch.stack(alphas)

    return render_fn


def _splat_major(name, x, cap) -> bool:
    return (isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] == cap
            and name not in REPLICATED_FIELDS)


def _map_state(state: GaussianState, fn, cap: int, **replace) -> GaussianState:
    def tree(d):
        return {k: (fn(v) if _splat_major(k, v, cap) else v) for k, v in d.items()}

    return dataclasses.replace(
        state, params=tree(state.params), aux=tree(state.aux),
        opt=AdamState(state.opt.count, tree(state.opt.mu), tree(state.opt.nu)), **replace)


def shard_splat_state(mesh: Mesh, state: GaussianState, logger=None) -> GaussianState:
    """This rank's tp shard of a whole state: rows [tp_i * cap / n_tp,
    (tp_i + 1) * cap / n_tp) of every splat-major leaf of params, Adam
    moments and aux (ZeRO-style: 1/n_tp of the memory per rank);
    `background` and `count` stay whole. A sharded state is returned as it
    is; a capacity that does not divide by n_tp stays whole, with a
    warning."""
    if state.global_capacity is not None:
        return state
    n_tp, cap = mesh.shape["tp"], state.capacity
    if cap % n_tp:
        (logger or log).warning("capacity %d %% tp %d != 0: the state stays whole on every "
                                "rank (no memory scaling)", cap, n_tp)
        return state
    rows = cap // n_tp
    lo = mesh.coords["tp"] * rows
    return _map_state(state, lambda v: v[lo:lo + rows].clone(), cap, global_capacity=cap)


def gather_splat_state(mesh: Mesh, state: GaussianState) -> GaussianState:
    """The inverse of `shard_splat_state`: every row on every rank of the
    tp group (for densify, capacity growth, checkpoints and PLYs)."""
    if state.global_capacity is None:
        return state
    group = mesh.group("tp")
    return _map_state(state, lambda v: X.all_gather_cat(v, group), state.capacity,
                      global_capacity=None)


def make_fps_camera_render(mesh: Mesh, width: int, height: int, sh_degree: int,
                           capacity: int, c_batch: int, chunk: int = 256,
                           shard_splats: bool = False):
    """The trainers' per-camera render loop on this rank: cameras over
    "dp", tile bands over "tp", with `shard_splats` splats over "tp" too.
    `capacity` is PER BAND.

    render_fn(inputs, cams, aug, probes, shs_noise=None, scale_noise=None):
      inputs: xyz [N,3], features [N,K,3], scaling (activated), rotation
        (normalized), opacities [N] (activated), active [N] — every row, or
        this rank's shard;
      cams: this rank's b_local camera dicts; aug: [b_local, 6] host floats
        (bg rgb, sh drop, shs noise, scale noise); probes [b_local, N, 2];
      shs_noise [b_local, N, K, 3], scale_noise [b_local, N, 3]: standard
        normal draws (None: no noise terms, as with zero aug flags).
    Returns a dict: images [b_local,3,band_h,W], disps and alphas
    [b_local,1,band_h,W] (this rank's band); radii / visible [N] of the
    last global camera (from its dp rank); `scale_share`, this rank's
    share of the mean scale term (the shares sum to it over the mesh, and
    each carries the gradient of its own rows), and `scales_mean`, the
    term itself (no gradient); n_entries / n_dropped, the max over the
    mesh. The disparity is normalized with statistics gathered across
    the bands (the gather's backward routes the normalization gradient to
    the owning band)."""
    n_tp, n_dp = mesh.shape["tp"], mesh.shape["dp"]
    band_h, band = band_geometry(mesh, height)
    if c_batch % n_dp:
        raise ValueError(f"C_batch {c_batch} does not split over dp {n_dp}")
    b_local = c_batch // n_dp
    tp_group, dp_group = mesh.group("tp"), mesh.group("dp")
    owner_dp = n_dp - 1                   # holds global camera c_batch - 1
    owns_last = mesh.coords["dp"] == owner_dp
    counts_scale = owns_last and (shard_splats or mesh.coords["tp"] == 0)

    def render_fn(inputs, cams, aug, probes, shs_noise=None, scale_noise=None):
        active = inputs["active"]
        dev = inputs["xyz"].device
        images, disps, alphas = [], [], []
        n_entries, n_dropped = [], []
        for i in range(b_local):
            a = [float(x) for x in aug[i]]
            cam = cams[i]
            shs = inputs["features"]
            shs = torch.cat([shs[:, :1], shs[:, 1:] * (1.0 - a[3])], dim=1)
            scales = inputs["scaling"]
            if shs_noise is not None:
                shs = shs + a[4] * shs_noise[i] * (0.2**0.5) * shs
            if scale_noise is not None:
                scales = torch.clamp_min(
                    scales + a[5] * scale_noise[i] * (0.2**0.5) * scales / 4, 0.0)
            splats = project_gaussians(
                inputs["xyz"], scales, inputs["rotation"], inputs["opacities"], shs,
                cam["viewmatrix"], cam["projmatrix"], cam["campos"], cam["tanfovx"],
                cam["tanfovy"], width, height, sh_degree=sh_degree, valid_mask=active)
            splats = splats._replace(means2d=splats.means2d + probes[i])
            gathered = gather_records(splats, tp_group) if shard_splats else splats
            out = render_from_splats(
                gathered, width, band_h, torch.tensor(a[:3], dtype=torch.float32, device=dev),
                capacity=capacity, chunk=chunk, pixel_offset_y=band)
            focal = 1.0 / (2.0 * cam["tanfovx"])
            disp = focal / (out["depth"] + out["alpha"] * 10.0 + 1e-5)
            empty = out["alpha"] <= 0.1
            stats = torch.stack([
                torch.where(empty, disp, torch.full_like(disp, float("inf"))).min(),
                disp.min(), -disp.max(), -empty.any().float()])
            stats = X.all_gather(stats[None], tp_group)          # [n_tp, 4]
            any_empty = stats[:, 3].min() < -0.5
            min_d = torch.where(any_empty, stats[:, 0].min(), stats[:, 1].min())
            max_disp = -stats[:, 2].min()
            disp = _clip((disp - min_d) / torch.clamp_min(max_disp - min_d, 1e-12), 0.0, 1.0)
            images.append(out["image"])
            disps.append(disp[None])
            alphas.append(out["alpha"][None])
            n_entries.append(out["n_entries"])
            n_dropped.append(out["n_dropped"])

        # densification inputs of the last global camera, from its dp rank
        src = mesh.ranks_of("dp")[owner_dp] if dp_group is not None else None
        radii = X.broadcast(splats.radii.clone(), src, dp_group)
        visible = X.broadcast(splats.visible.to(torch.uint8), src, dp_group).bool()
        if counts_scale:
            num = (scales * active[:, None]).sum()
            den = active.sum().float() * 3.0
            if shard_splats:
                den = X.all_reduce(den.detach().clone(), tp_group)
            share = num / torch.clamp_min(den, 1.0)
        else:
            share = scales.new_zeros(())
        scales_mean = X.all_reduce(share.detach().clone(), mesh.world_group)
        ent = torch.stack([torch.stack(n_entries).max(), torch.stack(n_dropped).max()]).long()
        X.all_reduce(ent, mesh.world_group, op=torch.distributed.ReduceOp.MAX)
        return dict(images=torch.stack(images), disps=torch.stack(disps),
                    alphas=torch.stack(alphas), radii=radii, visible=visible,
                    scale_share=share, scales_mean=scales_mean, n_entries=ent[0],
                    n_dropped=ent[1])

    return render_fn


def reduce_gradients(mesh: Mesh, grads: dict, sharded: bool) -> dict:
    """The step's gradient of every parameter, on every rank that holds
    it: a whole (replicated) tensor sums over the mesh; the rows of a tp
    shard, which already hold the whole tp group's contributions (the
    record gather's reduce-scatter), sum over "dp". One all-reduce each."""
    names = sorted(grads)
    rows = [k for k in names if sharded and k not in REPLICATED_FIELDS]
    whole = [k for k in names if k not in rows]
    out = dict(zip(rows, X.all_reduce_flat([grads[k] for k in rows], mesh.group("dp"))))
    out.update(zip(whole, X.all_reduce_flat([grads[k] for k in whole], mesh.world_group)))
    return out


def rank_cameras(mesh: Mesh, c_batch: int) -> slice:
    """This rank's cameras of a c_batch batch."""
    b_local = c_batch // mesh.shape["dp"]
    return slice(mesh.coords["dp"] * b_local, (mesh.coords["dp"] + 1) * b_local)


def text_rows(text_emb, c_batch: int, cams: slice):
    """Rows of a [3C, L, D] (cond | uncond | inverse) bank for the cameras
    `cams`, in the same block order."""
    return text_emb.reshape(3, c_batch, *text_emb.shape[1:])[:, cams].reshape(
        -1, *text_emb.shape[1:])


def make_sharded_train_step(mesh: Mesh, guidance, width: int, height: int, sh_degree: int,
                            capacity: int, guidance_scale: float = 7.5, chunk: int = 256,
                            shard_splats: bool = False):
    """Full multi-rank FPS training step: sharded render -> VAE encode and
    ladder of this rank's cameras -> all-reduced parameter gradients ->
    masked Adam.

    train_step(params, opt, active, cams, bg, text_emb, ladder, noise,
    vae_eps, lrs) takes the whole batch (cams: C camera dicts; bg [C, 3];
    text_emb [3C, L, D]; noise / vae_eps [C, h, w, 4]; ladder: host ints)
    and the rank's params (every row, or its shard with `shard_splats`);
    returns the new params, the new Adam state and the loss (summed over
    the mesh, each term once)."""
    from dreamscene_tpu_torch.guidance import mtsd

    mods = guidance.mods
    factory = make_primitive_sharded_render if shard_splats else make_sharded_render
    render_fn = factory(mesh, width, height, sh_degree, capacity, chunk)
    tp_group = mesh.group("tp")

    def train_step(params, opt, active, cams, bg, text_emb, ladder, noise, vae_eps, lrs):
        c_batch = len(cams)
        mine = rank_cameras(mesh, c_batch)
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        q = p["rotation"]
        inputs = dict(means3d=p["xyz"], scales=torch.exp(p["scaling"]),
                      quats=q / torch.linalg.norm(q, dim=-1, keepdim=True),
                      opacities=torch.sigmoid(p["opacity"][:, 0]),
                      shs=torch.cat([p["features_dc"], p["features_rest"]], dim=1),
                      valid_mask=active)
        images, _ = render_fn(inputs, cams[mine], bg[mine])
        images = X.gather_replicated(images, tp_group, dim=2)
        latents = mtsd.encode_images(mods, images, vae_eps[mine])
        scores = mtsd.ladder_scores(mods, latents.detach(), noise[mine], ladder,
                                    text_rows(text_emb, c_batch, mine))
        with torch.no_grad():
            grad = mtsd.csd_grad(mods, scores, guidance_scale)
        loss = mtsd.specify_gradient_loss(latents, grad)
        loss.backward()
        grads = reduce_gradients(mesh, {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                                        for k, v in p.items()}, shard_splats)
        new_params, new_opt = adam_update(params, grads, opt, active, lrs)
        report = loss.detach().clone() if mesh.coords["tp"] == 0 else torch.zeros_like(loss)
        return new_params, new_opt, X.all_reduce(report, mesh.world_group)

    return train_step
