"""Scene trainer: compositional text-to-3D scene optimization, torch.

Port of dreamscene_tpu/training/scene_trainer.py (reference
training/scene_trainer.py:20-1961):
  1. per-object FPS training (ObjectTrainer, finished PLYs are skipped);
  2. scene assembly: importance-filtered objects placed by their affine
     parameters, env and floor clouds, the scene prompt bank;
  3. stage 1 (env) and stage 2 (floor) guidance steps over the stage camera
     curricula;
  4. stage 3: a pseudo-GT bank, then per-view L2*100 recon steps (indoor
     key "all", objects included; outdoor the floor only);
  5. inference circle videos and the combined PLY.

`scene_step` is one step of stages 1-3 (the JAX package's jitted
`_scene_step_fn`): every camera renders the concatenated models (objects...,
floor, env) through the rasterizer (hand-written kernels on the card); the
guidance ladder and CSD (or the recon L2) give the loss; the backward runs
through the VAE encoder and the rasterizer's VJP; masked Adam updates the
trainable models only, and their densification statistics come from the
LAST camera's probe gradient, radii and visibility, sliced per model by
capacity (a reference quirk the JAX package keeps).

Host randomness (cameras, ladders, as_latent, background augmentation,
flips, densification seeds) comes from the same numpy generators in the
same order as the JAX trainer; tensor randomness (ladder noise, VAE
posterior eps, split samples) from torch Generators on the device, passed
to `scene_step` as explicit tensors.

Checkpoints (`scene_<n>_stage.ckpt.npz`) hold the env and floor in the
JAX package's leaf order, so either package resumes the other's.

A depth ControlNet conditions the stage-1/2 ladders when the guidance
has one and `MTSD.use_controlnet` lets it.

With parallelParams dp * tp > 1 the trainer is one rank of a mesh
(parallel/), as ObjectTrainer is: `scene_step` renders this rank's
cameras' tile bands of the concatenated models, with shard_splats each
model's state is kept as this rank's tp rows and the concatenated axis,
padded with inactive rows to a multiple of n_tp, is projected in shards.
A step whose C_batch does not split over dp (the stage-3 recon steps,
C_batch 1) folds the whole mesh into one group of dp * tp tile bands.
Densify, checkpoints, pseudo-GT banks and videos see the whole models;
files are written by rank 0.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from pathlib import Path

import numpy as np
import torch

from dreamscene_tpu_torch.cameras.scene_sampling import SceneCameraLoader
from dreamscene_tpu_torch.device import resolve_device
from dreamscene_tpu_torch.guidance import mtsd
from dreamscene_tpu_torch.models import densify as D
from dreamscene_tpu_torch.models.gaussians import (
    PARAM_FIELDS,
    AdamState,
    GaussianState,
    adam_update,
    create_from_points,
    group_lrs,
    num_active,
)
from dreamscene_tpu_torch.models.init import init_env_points, init_floor_points
from dreamscene_tpu_torch.models.ply import load_splat_ply, save_splat_ply
from dreamscene_tpu_torch.models.scene import (
    ObjectEntry,
    SceneModel,
    export_layout,
    final_combine_all,
    place_object,
)
from dreamscene_tpu_torch.ops import binning
from dreamscene_tpu_torch.ops.losses import tv_loss
from dreamscene_tpu_torch.parallel import collectives as X
from dreamscene_tpu_torch.parallel import distributed as PD
from dreamscene_tpu_torch.parallel import sharded_render as SR
from dreamscene_tpu_torch.rendering import concat_states, scene_render
from dreamscene_tpu_torch.training.capacity import CapacityController
from dreamscene_tpu_torch.training.filtering import importance_filter
from dreamscene_tpu_torch.training.object_trainer import (
    VD_DIRS,
    VD_NEG,
    ObjectTrainer,
    assemble_text_embeddings,
    camera_tensors,
    scale_up_camera_ranges,
)
from dreamscene_tpu_torch.utils.experiment import setup_experiment_logging
from dreamscene_tpu_torch.utils.media import write_video
from dreamscene_tpu_torch.utils.profiling import BackwardSpans

logger = logging.getLogger("dreamscene_tpu_torch")

# the JAX package's jax.tree.flatten order of {"params", "aux", "opt"}
AUX_FIELDS = ("active", "max_radii2d", "xyz_gradient_accum", "denom")


def calc_scene_text_embeddings(guidance: mtsd.MTSD, ref_text: str, negative_text: str,
                               cam_pose_method: str, opt_params) -> dict:
    """Scene prompt bank with indoor view variants and outdoor ground/sky
    variants for overhead/bottom (reference scene_trainer.py:134-189)."""
    sp = opt_params.style_prompt
    sn = opt_params.style_negative_prompt

    def vd_prompt(d):
        if cam_pose_method == "outdoor" and d == "overhead":
            return f"ground of {ref_text}, {sp}"
        if cam_pose_method == "outdoor" and d == "bottom":
            return f"sky of {ref_text}, {sp}"
        return f"{ref_text}, {d} view, {sp}"

    return {
        "default": guidance.get_text_embeds([f"{ref_text}, {sp}"]),
        "uncond": guidance.get_text_embeds([f"{negative_text}, {sn}"]),
        "inverse_text": guidance.get_text_embeds([guidance.guidance_opt.inverse_text]),
        "text_embeddings_vd": {d: guidance.get_text_embeds([vd_prompt(d)]) for d in VD_DIRS},
        "uncond_text_embeddings_vd": {
            d: guidance.get_text_embeds([f"{negative_text}, {VD_NEG[d]}, {sn}"])
            for d in VD_DIRS},
    }


def scene_step(states: list, trainable: tuple, mods: mtsd.GuidanceModules, cams: list,
               bg_rows, text_emb, ladder, noise, vae_eps, flip: bool, as_latent: bool,
               lrs_list: list, gt_images=None, *, width: int, height: int, capacity: int,
               guidance_on: bool, lambda_tv: float, lambda_tv_depth: float,
               lambda_scale: float, guidance_scale: float, lambda_guidance: float,
               use_cn: bool = False, mesh=None, state_mesh=None,
               shard_splats: bool = False) -> dict:
    """One scene step over the models `states` (objects..., floor, env).

    trainable: one bool per model; cams: per-camera dicts of view/proj/
    campos tensors and tan-fovs; bg_rows: [C, 3] host floats; noise /
    vae_eps: [C, h, w, 4]; lrs_list: per-model lr dicts; gt_images: [C, 3,
    H, W] for the recon loss (guidance_on False); use_cn: condition the
    ladder on the ControlNet with the flipped disparities. Returns per-model new
    params/opt/aux (the input's where not trainable), the loss, the peak
    n_entries / n_dropped over the cameras, the trainable models' raw
    gradients (None elsewhere), the last camera's probe gradient and
    `n_rows`, the rows concatenated over the models. The phases are marked
    as scene.* profiler ranges, the backward's parts too: `scene.rows`
    inside `scene.render` around the concatenation of the models' rows (and
    a shard's pad), `scene.render.bwd` from the gradients of the render's
    outputs to those of its inputs, `scene.vae_encode.bwd`
    (utils/profiling.BackwardSpans).

    With a `mesh` (parallel/), this rank's part of the step: the
    arguments are the whole batch on every rank; states sharded over
    `state_mesh` (default `mesh`) hold its rows. Cameras go over "dp" and
    tile bands over "tp" (`capacity` is per band). A model sharded over
    `state_mesh` is all-gathered into whole rows first (the gather's
    backward hands each rank its rows' gradient). The models are
    concatenated (objects..., floor, env) and, with `shard_splats`, padded
    with inactive rows to a multiple of n_tp, each rank projecting its
    slice of that axis (`make_fps_camera_render` with zero augmentation is
    the plain render). Each loss term is counted once: the band gather
    keeps each rank's own band, the image terms divide by the whole batch,
    the mean scale term is the mesh's first rank's. A model's gradient
    sums over the mesh (a shard's over "dp"); the last camera's probe
    gradient, radii and visibility are gathered whole and sliced per
    model. Without a mesh the step runs on a 1 x 1 mesh, where every
    collective is the identity."""
    # one process renders at the rasterizer's chunk, a mesh at the JAX
    # package's mesh chunk
    if mesh is None:
        mesh, state_mesh, shard_splats, chunk = SR.single_mesh(), None, False, 512
    else:
        chunk = 256
    state_mesh = state_mesh or mesh
    c_batch = len(cams)
    dev = states[0].device
    mine = SR.rank_cameras(mesh, c_batch)
    b_local = mine.stop - mine.start
    tp_group, dp_group = mesh.group("tp"), mesh.group("dp")
    s_tp = state_mesh.group("tp")
    params_list = [{k: v.detach().requires_grad_(tr) for k, v in s.params.items()}
                   for s, tr in zip(states, trainable)]
    whole = []
    for s, p, tr in zip(states, params_list, trainable):
        if s.global_capacity is None:
            whole.append(dataclasses.replace(s, params=p))
            continue
        gather = X.all_gather if tr else X.all_gather_cat
        wp = {k: (v if k in SR.REPLICATED_FIELDS else gather(v, s_tp)) for k, v in p.items()}
        whole.append(dataclasses.replace(
            s, params=wp, aux={"active": X.all_gather_cat(s.aux["active"], s_tp)},
            global_capacity=None))
    sh_degree = min(s.active_sh_degree for s in states)

    spans = BackwardSpans()
    with torch.profiler.record_function("scene.render"):
        with torch.profiler.record_function("scene.rows"):
            fields, offsets = concat_states(whole)
            total_c = int(offsets[-1])
            n_tp = mesh.shape["tp"]
            lo, hi = 0, total_c
            if shard_splats:
                pad = (-total_c) % n_tp
                if pad:
                    fields = {k: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
                              for k, v in fields.items()}
                rows = (total_c + pad) // n_tp
                lo, hi = mesh.coords["tp"] * rows, (mesh.coords["tp"] + 1) * rows
                fields = {k: v[lo:hi] for k, v in fields.items()}
        inputs = spans.end("scene.render.bwd", dict(
            xyz=fields["means3d"], features=fields["shs"], scaling=fields["scales"],
            rotation=fields["quats"], opacities=fields["opacities"], active=fields["valid_mask"]))
        probes = torch.zeros((b_local, hi - lo, 2), device=dev, requires_grad=True)
        render_fn = SR.make_fps_camera_render(mesh, width, height, sh_degree, capacity,
                                              c_batch, chunk=chunk, shard_splats=shard_splats)
        aug = [list(bg) + [0.0, 0.0, 0.0] for bg in bg_rows[mine]]
        out = render_fn(inputs, cams[mine], aug, probes)
        images, depths = spans.begin("scene.render.bwd", (
            X.gather_replicated(out["images"], tp_group, dim=2),
            X.gather_replicated(out["disps"], tp_group, dim=2)))

    share = b_local / c_batch
    scale_term = 0.0
    if guidance_on:
        loss_img = (mtsd.guidance_loss(mods, images, depths, flip, as_latent, vae_eps[mine],
                                       noise[mine], ladder, SR.text_rows(text_emb, c_batch, mine),
                                       guidance_scale, lambda_guidance, use_cn, "scene",
                                       spans=spans)
                    + lambda_tv * tv_loss(images) * share
                    + lambda_tv_depth * tv_loss(depths) * share)
        if PD.rank() == mesh.ranks[0]:
            # masked mean scale over the trainable models, counted on one rank
            s_sum, s_cnt = 0.0, 0.0
            for st, tr in zip(whole, trainable):
                if tr:
                    s_sum = s_sum + (torch.exp(st.params["scaling"])
                                     * st.aux["active"][:, None]).sum()
                    s_cnt = s_cnt + st.aux["active"].sum() * 3.0
            scale_term = lambda_scale * s_sum / torch.clamp_min(torch.as_tensor(s_cnt), 1.0)
    else:
        loss_img = 100.0 * torch.mean((images - gt_images[mine]) ** 2) * share
    with torch.profiler.record_function("scene.backward"):
        try:
            (loss_img + scale_term).backward()
        finally:
            spans.close()

    with torch.profiler.record_function("scene.allreduce"):
        last_probe = probes.grad[b_local - 1].clone()
        if not shard_splats:        # a shard's rows already hold every band's part
            X.all_reduce(last_probe, tp_group)
        X.broadcast(last_probe, mesh.ranks_of("dp")[-1], dp_group)
        radii, visible = out["radii"], out["visible"]
        if shard_splats:
            last_probe, radii, visible = (X.all_gather_cat(t, tp_group)[:total_c]
                                          for t in (last_probe, radii, visible))
        report = loss_img.detach() if mesh.coords["tp"] == 0 else torch.zeros_like(loss_img)
        report = X.all_reduce(report + torch.as_tensor(scale_term, device=dev).detach(),
                              mesh.world_group)
        grads = []
        for s, p, tr in zip(states, params_list, trainable):
            g = None
            if tr:
                g = SR.reduce_gradients(
                    state_mesh, {f: (v.grad if v.grad is not None else torch.zeros_like(v))
                                 for f, v in p.items()}, s.global_capacity is not None)
            grads.append(g)

    with torch.profiler.record_function("scene.adam"):
        new_params, new_opt, new_aux = [], [], []
        for m, (s, g, lrs) in enumerate(zip(states, grads, lrs_list)):
            if g is None:
                new_params.append(s.params)
                new_opt.append(s.opt)
                new_aux.append(s.aux)
                continue
            seg = slice(int(offsets[m]), int(offsets[m + 1]))
            if s.global_capacity is not None:
                first = int(offsets[m]) + state_mesh.coords["tp"] * s.capacity
                seg = slice(first, first + s.capacity)
            np_, no_ = adam_update(s.params, g, s.opt, s.aux["active"], lrs)
            na_ = D.update_max_radii(s.aux, radii[seg], visible[seg])
            na_ = D.add_densification_stats(na_, last_probe[seg], visible[seg])
            new_params.append(np_)
            new_opt.append(no_)
            new_aux.append(na_)
    return dict(params=new_params, opt=new_opt, aux=new_aux, loss=report,
                n_entries=out["n_entries"], n_dropped=out["n_dropped"], grads=grads,
                probe_grad=last_probe, n_rows=total_c)


def _ckpt_leaves(st: GaussianState) -> list:
    """The state's arrays in the JAX package's jax.tree.flatten order of
    {"params", "aux", "opt"}: aux, opt (count, mu, nu), params."""
    return ([st.aux[f] for f in AUX_FIELDS] + [np.asarray(st.opt.count, np.int32)]
            + [st.opt.mu[f] for f in PARAM_FIELDS] + [st.opt.nu[f] for f in PARAM_FIELDS]
            + [st.params[f] for f in PARAM_FIELDS])


def _state_from_leaves(st: GaussianState, arrays: list, active_sh_degree: int) -> GaussianState:
    n_aux, n_p = len(AUX_FIELDS), len(PARAM_FIELDS)
    t = [torch.as_tensor(a, device=st.device) for a in arrays]
    aux = dict(zip(AUX_FIELDS, t[:n_aux]))
    aux["active"] = aux["active"].bool()
    mu = dict(zip(PARAM_FIELDS, t[n_aux + 1:n_aux + 1 + n_p]))
    nu = dict(zip(PARAM_FIELDS, t[n_aux + 1 + n_p:n_aux + 1 + 2 * n_p]))
    params = dict(zip(PARAM_FIELDS, t[n_aux + 1 + 2 * n_p:]))
    return dataclasses.replace(st, params=params, aux=aux,
                               opt=AdamState(count=int(arrays[n_aux]), mu=mu, nu=nu),
                               active_sh_degree=active_sh_degree)


class SceneTrainer:
    """Three-stage scene trainer on `device` ("cuda" by default)."""

    def __init__(self, cfg, guidance: mtsd.MTSD | None = None, exp_root: str = "experiments",
                 device: str | torch.device = "cuda", env_density: float = 1.0):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.pose_args = cfg.generateCamParams
        self.scene_pose_args = cfg.sceneGenerateCamParams
        self.guidance_opt = cfg.guidanceParams
        self.dataset_args = cfg.modelParams
        self.env_density = env_density  # < 1 shrinks the env/floor inits

        exp_name = "default"
        if isinstance(cfg.log, dict):
            exp_name = cfg.log.get("exp_name", "default")
        self.exp_path = Path(exp_root) / exp_name
        self.ckpt_path = self.exp_path / "checkpoints"
        self.scene_ckpt_path = self.exp_path / "scene_checkpoints"
        self.vis_path = self.exp_path / "vis"
        for p in (self.ckpt_path, self.scene_ckpt_path, self.vis_path):
            p.mkdir(parents=True, exist_ok=True)
        # multi-rank mesh (parallelParams, as in ObjectTrainer: dp cameras x
        # tp tile bands; shard_splats also splits each model's rows)
        par = getattr(cfg, "parallelParams", None)
        self.mesh = None
        self.shard_splats = False
        self._flat_mesh = None
        if par is not None and par.dp * par.tp > 1:
            self.mesh = SR.make_mesh(par.dp, par.tp)
            self.shard_splats = bool(par.shard_splats)
        self.rank0 = PD.rank() == 0
        if self.rank0:
            setup_experiment_logging(self.exp_path, cfg)

        self.rng = np.random.default_rng(cfg.seed)
        self.cameras_extent = self.pose_args.default_radius
        self.guidance = guidance
        self.scene = SceneModel()
        self.step = 0
        self.iters = cfg.sceneOptimizationParams.iterations
        self.current_prev_n = 0
        self.bg_color = (0.0, 0.0, 0.0)
        self.last_stats: dict = {}
        # scene renders start at 2x the total splat capacity (mult 4 // 2)
        self.cap_ctrl = CapacityController(mult=4, min_mult=2, max_mult=16)

        sc = cfg.scene_configs or {}
        self.scene_objects = sc.get("objects") or []
        self.scene_cfg = sc.get("scene") or {}
        self.cam_pose_method = self.scene_cfg.get("cam_pose_method", "indoor")

    def _rank0_only(self, fn):
        """fn() on rank 0 alone (files); the others wait."""
        if self.rank0:
            fn()
        if self.mesh is not None:
            PD.barrier()

    def _whole(self, state):
        """Every row of a model on every rank."""
        return state if self.mesh is None else SR.gather_splat_state(self.mesh, state)

    def _step_mesh(self, c_batch: int, height: int):
        """The mesh a step of c_batch cameras runs on: the trainer's, or,
        when c_batch does not split over dp, one group of dp * tp tile
        bands over the same ranks; None (the single-device step on every
        rank) when the height has no such tile-aligned bands."""
        if c_batch % self.mesh.shape["dp"] == 0:
            return self.mesh
        n_flat = self.mesh.size
        if height % n_flat == 0 and (height // n_flat) % binning.DEFAULT_TILE_H == 0:
            if self._flat_mesh is None:
                logger.info("scene step c_batch=%d %% dp=%d != 0 — folding the mesh to "
                            "(1x%d) tile bands for this step", c_batch,
                            self.mesh.shape["dp"], n_flat)
                self._flat_mesh = SR.make_mesh(1, n_flat, ranks=self.mesh.ranks)
            return self._flat_mesh
        logger.info("scene step c_batch=%d %% dp=%d != 0 and height %d has no %d "
                    "tile-aligned bands — this step runs the single-device path",
                    c_batch, self.mesh.shape["dp"], height, n_flat)
        return None

    # ------------------------------------------------------------------
    def object_task(self, obj_cfg: dict) -> GaussianState:
        """Train (or load) one object (reference scene_trainer.py:337-346)."""
        from dreamscene_tpu_torch.utils.config import ObjectParams

        cfg = dataclasses.replace(self.cfg)
        op = ObjectParams(**{k: v for k, v in obj_cfg.items() if hasattr(ObjectParams(), k)})
        cfg.objectParams = op
        trainer = ObjectTrainer(cfg, guidance=self.guidance, obj_id=op.id,
                                exp_root=str(self.exp_path.parent), device=self.device)
        trainer.exp_path = self.exp_path
        trainer.ckpt_path = self.ckpt_path
        trainer.train()
        self.guidance = trainer.guidance
        return trainer.state

    def compress_objects(self, composition):
        """Importance-filter each trained object PLY before placement into
        `<id>_final_model_compressed.ply` (reference scene_gaussian.py:
        222-238); objects already compressed are skipped."""
        prune_percent = float(self.scene_cfg.get("compress_prune_percent", 0.5))
        todo = [obj for obj in composition
                if (self.ckpt_path / f"{obj['id']}_final_model.ply").exists()
                and not (self.ckpt_path / f"{obj['id']}_final_model_compressed.ply").exists()]
        if self.mesh is not None:
            PD.barrier()         # every rank has decided before rank 0 writes
        for obj in todo:
            ply = self.ckpt_path / f"{obj['id']}_final_model.ply"
            cply = self.ckpt_path / f"{obj['id']}_final_model_compressed.ply"
            st = load_splat_ply(str(ply), sh_degree=None, device=self.device)
            n0 = num_active(st)
            # every rank filters (self.rng advances alike); rank 0 writes
            st = importance_filter(st, self.rng, self.pose_args, bg_color=self.bg_color,
                                   prune_percent=prune_percent,
                                   n_views=int(self.scene_cfg.get("compress_n_views", 48)))
            self._rank0_only(lambda: save_splat_ply(str(cply), st))
            logger.info("compress_objects: %s %d -> %d points", obj["id"], n0, num_active(st))

    def prepare_train_scene(self):
        """Assemble the scene: placed objects, env and floor, the prompt
        bank, the camera loader; then resume from the latest stage
        checkpoint (reference scene_trainer.py:103-189)."""
        # controlnet_model_key is read only by build_sd_guidance, as in JAX
        if self.guidance is None:
            self.guidance = mtsd.make_tiny_guidance(self.guidance_opt, device=self.device)

        sc = self.scene_cfg
        self.scene = SceneModel(scene_box=np.zeros(6, np.float32))
        composition = sc.get("scene_composition") or []
        compress = sc.get("compress_objects", True)
        if compress:
            self.compress_objects(composition)
        count = 0
        for obj in composition:
            ply = self.ckpt_path / f"{obj['id']}_final_model.ply"
            cply = self.ckpt_path / f"{obj['id']}_final_model_compressed.ply"
            if compress and cply.exists():
                ply = cply
            base = load_splat_ply(str(ply), sh_degree=None, device=self.device)
            for tp in obj["params"]:
                placed, args, bbox = place_object(base, tp["center"], tp["rotation"],
                                                  tp["scale"])
                args.object_id = obj["id"]
                args.clas = count
                name = f"{count}_{obj['id']}"
                self.scene.objects[name] = ObjectEntry(id=name, state=placed)
                self.scene.objects_args.append(args)
                self.scene.grow_box(bbox)
                count += 1

        cfg_box = np.zeros(6, np.float32)
        cfg_box[3:] = np.asarray(sc.get("radius", [3.5, 2.5, 5.0]), np.float32)
        if sc.get("zero_ground", True):
            cfg_box[:2] = -cfg_box[3:5]
        else:
            cfg_box[:3] = -cfg_box[3:]
        self.scene.grow_box(cfg_box)

        env_pts, env_cols = init_env_points(
            self.cam_pose_method, self.scene.scene_box,
            env_init_color=sc.get("env_init_color", (255, 255, 255)),
            zero_ground=sc.get("zero_ground", True), seed=self.cfg.seed,
            density=self.env_density)
        floor_pts, floor_cols = init_floor_points(
            self.cam_pose_method, self.scene.scene_box,
            floor_init_color=sc.get("floor_init_color", (255, 255, 255)),
            zero_ground=sc.get("zero_ground", True), seed=self.cfg.seed + 1,
            density=self.env_density)
        deg = sc.get("sh_degree", 1)
        max_pts = self.cfg.sceneOptimizationParams.max_point_number
        self.scene.env = create_from_points(
            env_pts, env_cols, sh_degree=deg,
            capacity=min(int(env_pts.shape[0] * 1.5), max_pts), device=self.device)
        self.scene.floor = create_from_points(
            floor_pts, floor_cols, sh_degree=deg,
            capacity=min(int(floor_pts.shape[0] * 1.5), max_pts // 3), device=self.device)

        self._rank0_only(lambda: export_layout(self.scene.scene_box, self.scene.objects_args,
                                               str(self.exp_path / "layout.jpg"),
                                               seed=self.cfg.seed))
        self.embeddings = calc_scene_text_embeddings(
            self.guidance, sc.get("scene_text", ""), sc.get("negative_text", ""),
            self.cam_pose_method, self.cfg.sceneOptimizationParams)
        self.cams_loader = SceneCameraLoader(self.rng, self.scene_pose_args,
                                             self.scene.scene_box, self.scene.objects_args,
                                             self.cam_pose_method)
        self._maybe_resume()

    # -- checkpointing ---------------------------------------------------
    def save_ckpt(self):
        path = self.scene_ckpt_path / f"scene_{self.scene.stage_n}_stage.ckpt.npz"
        flat = {}
        for name, st in (("env", self._whole(self.scene.env)),
                         ("floor", self._whole(self.scene.floor))):
            for i, leaf in enumerate(_ckpt_leaves(st)):
                flat[f"{name}_{i}"] = (leaf.cpu().numpy() if isinstance(leaf, torch.Tensor)
                                       else leaf)
            flat[f"{name}_meta"] = np.asarray([st.sh_degree, st.active_sh_degree], np.int32)
        flat["stage_n"] = np.asarray(self.scene.stage_n)
        self._rank0_only(lambda: np.savez_compressed(path, **flat))
        logger.info("saved scene ckpt %s", path)

    def _maybe_resume(self):
        best, best_path = 0, None
        for f in os.listdir(self.scene_ckpt_path):
            if f.startswith("scene_") and f.endswith("_stage.ckpt.npz"):
                n = int(f.split("_")[1])
                if n > best:
                    best, best_path = n, self.scene_ckpt_path / f
        if best_path is None:
            return
        with np.load(best_path) as data:
            for name in ("env", "floor"):
                st = getattr(self.scene, name)
                n_leaves = len(_ckpt_leaves(st))
                arrays = [data[f"{name}_{i}"] for i in range(n_leaves)]
                setattr(self.scene, name,
                        _state_from_leaves(st, arrays, int(data[f"{name}_meta"][1])))
            self.scene.stage_n = int(data["stage_n"])
        logger.info("resumed scene at stage %d", self.scene.stage_n)

    # ------------------------------------------------------------------
    def _visible_names(self, only_env: bool):
        return [] if only_env else list(self.scene.objects)

    def _states(self, names):
        """Concat order: objects..., floor, env (scene_gaussian.py:753-846)."""
        return [self.scene.objects[n].state for n in names] + [self.scene.floor, self.scene.env]

    def _write_back_states(self, names, states):
        """Inverse of _states."""
        for i, n in enumerate(names):
            self.scene.objects[n].state = states[i]
        self.scene.floor = states[-2]
        self.scene.env = states[-1]

    def step_inputs(self, cameras, key_gs, only_env, scene_optim, stage_step_rate,
                    guidance_on=True, gt_images=None, optp=None) -> dict:
        """Host side of one scene step, in the JAX trainer's draw order
        (`_run_scene_step`): as_latent, ladder, noise, learning rates,
        per-camera background augmentation, VAE eps, flip. Returns the
        arguments of `scene_step` and the visible model names. On a mesh
        the arguments name the step's mesh (`_step_mesh`) and the entry
        capacity of one tile band."""
        optp = optp or self.cfg.sceneOptimizationParams
        names = self._visible_names(only_env)
        states = self._states(names)
        if self.mesh is not None and self.shard_splats:
            # persist each model as this rank's tp rows (no-op once sharded)
            states = [SR.shard_splat_state(self.mesh, st, logger) for st in states]
            self._write_back_states(names, states)
        n_rows = [st.global_capacity or st.capacity for st in states]
        trainable = tuple([scene_optim] * len(names)
                          + [key_gs in ("floor", "all"), key_gs in ("env", "all")])
        c_batch = len(cameras)
        g = self.guidance
        text_emb, _ = assemble_text_embeddings(self.embeddings, cameras)
        # `or` short-circuits: no draw while step < geo_iter
        as_latent = ((self.step < optp.geo_iter
                      or self.rng.random() < optp.as_latent_ratio * stage_step_rate)
                     if guidance_on else False)
        ladder = [int(t) for t in g.sample_ladder(stage_step_rate)]
        h, w = self.scene_pose_args.image_h, self.scene_pose_args.image_w
        lat_shape = g.latent_shape(c_batch, h, w)
        noise = g.next_noise(lat_shape)
        fine_opt = self.cfg.fineSceneOptimizationParams
        lrs_list = [group_lrs(fine_opt if (i < len(names) and scene_optim) else optp,
                              s.spatial_lr_scale, self.step) for i, s in enumerate(states)]
        bg_rows = []
        ratio = self.dataset_args.bg_aug_ratio * stage_step_rate if guidance_on else 0.0
        for _ in range(c_batch):
            bg = list(self.bg_color)
            if self.rng.random() < ratio:
                bg = list(self.rng.random(3)) if self.rng.random() < 0.5 else [0.0, 0.0, 0.0]
            bg_rows.append(bg)
        # JAX's order on the guidance's generator: ladder, ControlNet gate, flip
        use_cn = guidance_on and g.use_controlnet(self.step, self.cfg.sceneOptimizationParams)
        vae_eps = g.next_normal(lat_shape)
        flip = g.should_flip() if guidance_on else False
        capacity = int(self.cap_ctrl.mult * sum(n_rows)) // 2
        gt = (torch.zeros((c_batch, 3, h, w), device=self.device) if gt_images is None
              else torch.stack(list(gt_images)))
        mesh_args = {}
        if self.mesh is not None:
            step_mesh = self._step_mesh(c_batch, h)
            if step_mesh is None:
                states = [self._whole(st) for st in states]
            else:
                # the entry capacity is per tile band
                mesh_args = dict(mesh=step_mesh, state_mesh=self.mesh,
                                 shard_splats=self.shard_splats)
                capacity = max(capacity // step_mesh.shape["tp"], 4096)
        return dict(
            names=names,
            args=dict(states=states, trainable=trainable, mods=g.mods,
                      cams=camera_tensors(cameras, self.device), bg_rows=bg_rows,
                      text_emb=text_emb, ladder=ladder, noise=noise, vae_eps=vae_eps,
                      flip=flip, as_latent=as_latent, lrs_list=lrs_list, gt_images=gt,
                      width=w, height=h, capacity=capacity, guidance_on=guidance_on,
                      lambda_tv=optp.lambda_tv, lambda_tv_depth=optp.lambda_tv_depth,
                      lambda_scale=optp.lambda_scale,
                      guidance_scale=self.guidance_opt.guidance_scale,
                      lambda_guidance=self.guidance_opt.lambda_guidance, use_cn=use_cn,
                      **mesh_args))

    @torch.profiler.record_function("scene.step")
    def _run_scene_step(self, cameras, key_gs, only_env, scene_optim, stage_step_rate,
                        guidance_on=True, gt_images=None, optp=None) -> float:
        """Shared body of the stage-1/2 step and the stage-3 recon step, as
        the `scene.step` profiler range; its host side is
        `scene.step_inputs`, the host's read of the loss and the entry
        counts `scene.sync`."""
        with torch.profiler.record_function("scene.step_inputs"):
            inp = self.step_inputs(cameras, key_gs, only_env, scene_optim, stage_step_rate,
                                   guidance_on, gt_images, optp)
        names, args = inp["names"], inp["args"]
        cap_base = sum(s.global_capacity or s.capacity for s in args["states"]) // 2
        if self.mesh is not None:
            # n_entries / n_dropped are per tile band: the controller sizes
            # the per-band table
            cap_base = max(cap_base // self.mesh.shape["tp"], 4096)
        res = scene_step(**args)
        with torch.profiler.record_function("scene.sync"):
            loss, n_entries, n_dropped = torch.stack(
                [res["loss"].double(), res["n_entries"].double(),
                 res["n_dropped"].double()]).tolist()
        self.last_stats = dict(n_entries=int(n_entries), n_dropped=int(n_dropped),
                               n_rungs=len(args["ladder"]), capacity=args["capacity"],
                               n_rows=res["n_rows"])
        if self.cap_ctrl.update(cap_base, int(n_entries), int(n_dropped)):
            logger.info("scene entry capacity multiplier -> %.2fx/2", self.cap_ctrl.mult)
        self._write_back_states(names, [
            dataclasses.replace(s, params=p, opt=o, aux=a)
            for s, p, o, a in zip(args["states"], res["params"], res["opt"], res["aux"])])
        return float(loss)

    @torch.profiler.record_function("scene.densify")
    def _densify_model(self, which: str, optp, max_pts: int, size_threshold=None):
        """densify_and_prune with split samples seeded from the host
        generator, consumed where the JAX trainer draws its key; the
        `scene.densify` profiler range."""
        st = self._whole(getattr(self.scene, which))
        setattr(self.scene, which, st)
        if num_active(st) < max_pts:
            seed = int(self.rng.integers(0, 2**31))
            gen = torch.Generator(device=self.device).manual_seed(seed)
            eps = torch.randn((st.capacity, 2, 3), generator=gen, device=self.device)
            n0 = num_active(st)
            st = D.densify_and_prune(st, eps, optp.densify_grad_threshold, 0.005,
                                     self.cameras_extent, size_threshold, optp.percent_dense)
            setattr(self.scene, which, st)
            logger.debug("%s densify: %d -> %d", which, n0, num_active(st))
        else:
            logger.debug("%s at cap (%d), skip densify", which, num_active(st))

    def scene_train_step(self, cameras, key_gs, only_env=False) -> float:
        """Stage-1/2 step (reference scene_train_step, scene_trainer.py:699-1080)."""
        self.step += 1
        optp = self.cfg.sceneOptimizationParams
        if self.step % 500 == 0:
            if key_gs in ("env", "all"):
                self.scene.env = self.scene.env.one_up_sh_degree()
            if key_gs in ("floor", "all"):
                self.scene.floor = self.scene.floor.one_up_sh_degree()
        if not optp.use_progressive:
            if (self.step >= optp.progressive_view_iter
                    and self.step % optp.scale_up_cameras_iter == 0):
                scale_up_camera_ranges(self.scene_pose_args, optp)
        rate = min(self.step / max(self.iters, 1), 1.0)
        loss = self._run_scene_step(cameras, key_gs, only_env, False, rate)
        if self.step < optp.densify_until_iter:
            if (self.step >= optp.densify_from_iter
                    and self.step % optp.densification_interval == 0):
                if key_gs in ("env", "all"):
                    self._densify_model("env", optp, optp.max_point_number)
                if key_gs in ("floor", "all"):
                    self._densify_model("floor", optp, optp.max_point_number // 3)
        return loss

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _pseudo_gt_bank(self, cams, only_env) -> list:
        """One pseudo-GT image per camera, C_batch at a time (reference
        scene_trainer.py:1596-1735)."""
        g = self.guidance
        states = [self._whole(st) for st in self._states(self._visible_names(only_env))]
        step_size = self.guidance_opt.C_batch_size
        h, w = self.scene_pose_args.image_h, self.scene_pose_args.image_w
        gts = []
        for j in range(0, self.gt_size // 4 * 4, step_size):
            chunk = cams[j:j + step_size]
            imgs = torch.stack([scene_render(states, cam, bg_color=self.bg_color)["image"]
                                for cam in chunk])
            text_emb, _ = assemble_text_embeddings(self.embeddings, chunk)
            ladder = g.sample_ladder(0.0)
            lat_shape = g.latent_shape(len(chunk), h, w)
            noise = g.next_noise(lat_shape)
            latents = mtsd.encode_images(g.mods, imgs, g.next_normal(lat_shape))
            scores = mtsd.ladder_scores(g.mods, latents, noise, ladder, text_emb)
            gts.extend(mtsd.pseudo_gt_images(g.mods, scores,
                                             self.guidance_opt.guidance_scale).unbind(0))
        return gts

    def scene_refine_phase(self, only_env, scene_optim):
        """Stage 3 (reference scene_refine_step[_outdoor], scene_trainer.py:
        1082-1958): pseudo-GT bank(s) once, then per-view L2*100 recon steps
        with densification and opacity resets. Indoor: key "all", every
        model (objects through scene_optim); outdoor: key "floor" on every
        iteration, so only the floor bank is built and the floor trained."""
        optp = self.cfg.reconSceneOptimizationParams
        self.guidance.stage_range = (140, 200)
        self.guidance.jump_range = (75, 150)
        cams = self.scene_cams[:self.gt_size]
        keys = ["floor"] if self.cam_pose_method == "outdoor" else ["all"]
        banks = {k: self._pseudo_gt_bank(cams, only_env) for k in dict.fromkeys(keys)}
        rec_count = 0
        for it in range(self.n_stage3):
            self.step += 1
            key_gs = keys[it % len(keys)]
            env_on = key_gs in ("env", "all")
            floor_on = key_gs in ("floor", "all")
            if self.step % 300 == 0:
                if env_on:
                    self.scene.env = self.scene.env.one_up_sh_degree()
                if floor_on:
                    self.scene.floor = self.scene.floor.one_up_sh_degree()
            gts = banks[key_gs]
            for i in range(len(gts)):
                rec_count += 1
                self._run_scene_step([cams[i]], key_gs, only_env, scene_optim, 1.0,
                                     guidance_on=False, gt_images=[gts[i]], optp=optp)
                if rec_count % optp.densification_interval == 0:
                    size_thr = 20 if self.step > optp.opacity_reset_interval else None
                    if env_on:
                        self._densify_model("env", optp, optp.max_point_number, size_thr)
                    if floor_on:
                        self._densify_model("floor", optp, optp.max_point_number // 3,
                                            size_thr)
                if rec_count % optp.opacity_reset_interval == 0:
                    if env_on:
                        self.scene.env = D.reset_opacity(self.scene.env)
                    if floor_on:
                        self.scene.floor = D.reset_opacity(self.scene.floor)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def scene_video_inference(self, tag, only_env=False, max_frames=None):
        """Walkthrough rgb + depth videos (reference scene_trainer.py:262-295),
        rendered and written by rank 0."""
        states = [self._whole(st) for st in self._states(self._visible_names(only_env))]
        self._rank0_only(lambda: self._write_videos(states, tag, max_frames))

    def _write_videos(self, states, tag, max_frames):
        frames, depths, alphas = [], [], []
        for cam in self.scene_cams_inference[:max_frames]:
            out = scene_render(states, cam, bg_color=self.bg_color)
            img = torch.clamp(out["image"], 0, 1).cpu().numpy()
            frames.append((np.transpose(img, (1, 2, 0)) * 255).astype(np.uint8))
            a = out["alpha"].cpu().numpy()
            depths.append(out["depth"].cpu().numpy() / np.maximum(a, 1e-6))
            alphas.append(a)
        if frames:
            write_video(str(self.vis_path / f"video_rgb_scene_{tag}.mp4"), frames)
            # one normalization window across the walkthrough
            fg = [d[a > 0.5] for d, a in zip(depths, alphas) if (a > 0.5).any()]
            lo = min((f.min() for f in fg), default=0.0)
            hi = max((f.max() for f in fg), default=1.0) + 1e-6
            dframes = [np.repeat((np.clip((d - lo) / (hi - lo), 0, 1) * (a > 0.1) * 255)
                                 .astype(np.uint8)[..., None], 3, -1)
                       for d, a in zip(depths, alphas)]
            write_video(str(self.vis_path / f"video_depth_scene_{tag}.mp4"), dframes)

    # ------------------------------------------------------------------
    def train(self, n_stage3: int = 25, make_videos: bool = False, video_every: int = 300):
        """Objects, scene assembly, stages 1-3 (each resumable from its
        checkpoint), the final videos and `scene_final_model.ply`; returns
        the combined model."""
        for obj_cfg in self.scene_objects:
            self.object_task(obj_cfg)
        if self.cfg.reconOptimizationParams.only_recon_stage:
            return None

        self.prepare_train_scene()
        loader = self.cams_loader
        c_batch = self.guidance_opt.C_batch_size
        self.scene_cams_inference = []
        for oa in self.scene.objects_args:
            self.scene_cams_inference += loader.Circle(affine_params=oa.affine, circle_size=24)
        self.scene_cams_inference += loader.Circle(circle_size=24)

        if getattr(self.cfg, "only_render", False):
            self.scene_only_render()
            return None

        outdoor = self.cam_pose_method == "outdoor"
        self.n_stage1 = self.cfg.sceneOptimizationParams.iterations
        if self.scene.stage_n == 0:
            logger.info("Stage-1 (env)")
            self.step = 0
            self.iters = self.n_stage1
            cams = self._stage1_cams(self.n_stage1 * c_batch)
            for i in range(self.n_stage1):
                self.scene_train_step(cams[i * c_batch:(i + 1) * c_batch], "env",
                                      only_env=outdoor)
                if make_videos and (i + 1) % video_every == 0:
                    self.scene_video_inference(str(self.step + self.current_prev_n),
                                               only_env=outdoor)
            self.scene.stage_n = 1
            self.save_ckpt()
        self.current_prev_n += self.n_stage1

        self.n_stage2 = max(self.cfg.sceneOptimizationParams.iterations - 300, 1)
        if self.scene.stage_n == 1:
            logger.info("Stage-2 (floor)")
            self.step = 0
            self.iters = self.n_stage2
            if outdoor:
                self.guidance.stage_range = (350, 800)
                self.guidance.jump_range = (150, 200)
            cams = self._stage2_cams(self.n_stage2 * c_batch)
            self.guidance.stage_range = (350, 750)
            self.guidance.jump_range = (150, 200)
            for i in range(self.n_stage2):
                self.scene_train_step(cams[i * c_batch:(i + 1) * c_batch], "floor",
                                      only_env=False)
                if make_videos and (i + 1) % max(video_every - 100, 1) == 0:
                    self.scene_video_inference(str(self.step + self.current_prev_n),
                                               only_env=outdoor)
            self.scene.stage_n = 2
            self.save_ckpt()
        self.current_prev_n += self.n_stage2

        self.n_stage3 = n_stage3
        if self.scene.stage_n == 2:
            logger.info("Stage-3 (refine)")
            self.step = 0
            self.scene_cams = self._stage3_cams(20 * c_batch)
            self.rng.shuffle(self.scene_cams)
            self.gt_size = len(self.scene_cams) // 4 * 4
            if outdoor:
                self.scene_refine_phase(only_env=True, scene_optim=False)
            else:
                self.scene_refine_phase(only_env=False, scene_optim=True)
            self.scene.stage_n = 3
            self.save_ckpt()
        if make_videos:
            self.scene_video_inference("final")

        combined = final_combine_all([self._whole(st)
                                      for st in self._states(self._visible_names(False))])
        self._rank0_only(lambda: save_splat_ply(
            str(self.scene_ckpt_path / "scene_final_model.ply"), combined))
        return combined

    # -- stage camera pools ---------------------------------------------
    def _stage1_cams(self, n_max):
        cams = []
        mid = n_max * 0.7
        obj_count = 0
        while len(cams) < n_max:
            if self.cam_pose_method == "outdoor":
                cams += self.cams_loader.Stage1_Outdoor()
                if len(cams) > mid:
                    cams += self.cams_loader.Stage1_Outdoor2()
            else:
                cams += self.cams_loader.Stage1_Indoor()
                if len(cams) > mid and self.rng.random() > 0.7:
                    try:
                        oa = self.scene.objects_args[
                            obj_count % max(len(self.scene.objects_args), 1)]
                        cams += self.cams_loader.Stage2_Indoor(affine_params=oa.affine)
                    except (IndexError, RuntimeError):   # no objects; sampling failed
                        logger.debug("camera sampling failure around object")
                    finally:
                        obj_count += 1
        return cams

    def _stage2_cams(self, n_max):
        cams = []
        obj_count = 0
        while len(cams) < n_max:
            if self.cam_pose_method == "outdoor":
                cams += self.cams_loader.Stage2_Outdoor()
            else:
                rcc = self.rng.random()
                if rcc < 0.25 and self.scene.objects_args:
                    oa = self.scene.objects_args[obj_count % len(self.scene.objects_args)]
                    try:
                        cams += self.cams_loader.Stage2_Indoor(affine_params=oa.affine)
                    except RuntimeError:
                        logger.debug("camera sampling failure around object")
                    finally:
                        obj_count += 1
                elif rcc < 0.75:
                    cams += self.cams_loader.Stage2_Indoor()
                else:
                    cams += self.cams_loader.Stage1_Indoor(size=8, view_floor=True)
        return cams

    def _stage3_cams(self, n_max):
        cams = []
        i = 0
        if self.cam_pose_method == "outdoor":
            cams = self.cams_loader.Stage3_Outdoor("env")
            while len(cams) < n_max:
                cams += self.cams_loader.Stage2_Outdoor()
        else:
            while len(cams) < n_max:
                if self.rng.random() < 0.5:
                    cams += self.cams_loader.Stage1_Indoor(size=12, view_floor=True)
                else:
                    cams += self.cams_loader.Stage2_Indoor(idx=i % 12, size=12)
                i += 1
        return cams

    # ------------------------------------------------------------------
    def scene_only_render(self, start_points=None, stop_points=None):
        """Walkthrough render paths (reference scene_only_render,
        scene_trainer.py:355-426)."""
        if start_points is None:
            if self.cam_pose_method == "indoor":
                start_points = [[-3.0, 0, 2.2], [1.5, 0.0, 2.2], [-1.0, 0.0, 2.2]]
                stop_points = [[1.5, 0, 2.2], [-1.0, 0.0, 2.2], [1.0, 1.0, 2.2]]
            else:
                start_points = [[-3, -2, 2.5], [4, -2, 2.5], [0, -4, 2.5]]
                stop_points = [[3, -2, 2.5], [-4, 0, 2.5], [0, -2, 2.5]]
        cams = []
        end_point = [0, 0, 0]
        for n, (a, b) in enumerate(zip(start_points, stop_points)):
            cams += self.cams_loader.Line(a, b, 0.1)
            aff = {"T": np.asarray(b, np.float64), "R": np.zeros(3), "S": np.ones(3)}
            start_phi = float(np.degrees(np.arctan2(a[0] - b[0], a[1] - b[1])))
            if n + 1 == len(start_points):
                end_phi = float(np.degrees(np.arctan2(b[0] - end_point[0], b[1] - end_point[1])))
            else:
                a2, b2 = start_points[n + 1], stop_points[n + 1]
                end_phi = float(np.degrees(np.arctan2(a2[0] - b2[0], a2[1] - b2[1])))
            cams += self.cams_loader.Circle2(start_phi=start_phi, end_phi=end_phi,
                                             affine_params=aff, circle_size=180, render45=False)
        cams += self.cams_loader.Circle3()
        self.scene_cams_inference = cams
        self.scene_video_inference("render")
        return cams
