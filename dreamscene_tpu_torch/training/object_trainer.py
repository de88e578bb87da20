"""Object trainer: Formation Pattern Sampling + reconstructive refinement,
torch.

Port of dreamscene_tpu/training/object_trainer.py (reference:
training/object_trainer.py:19-738):
  * `fps_step`, one FPS training step: render C_batch cameras through the
    rasterizer (hand-written kernels on the card) with per-camera SH/scale
    noise augmentation; VAE-encode the renders (or the disparity maps,
    `as_latent`); the DDIM-inversion UNet ladder (no grad) and the CSD
    gradient; loss = sum(latents * sg(grad)) + lambda_tv*(tv(img)+tv(disp))
    + lambda_scale * mean scale; backward through the VAE encoder and the
    rasterizer's VJP; masked Adam; densification statistics from the last
    camera (a reference quirk the JAX package keeps);
  * `ObjectTrainer.train_step`: the step plus the densify/prune cadence,
    opacity reset, capacity growth, the step-1500 importance filter and
    the guidance visualization;
  * `refine_phase` / `recon_step`: pseudo-GT from the 36-view reco rig,
    then per-view L2*100 updates;
  * `train()`: resume from a snapshot, FPS steps, snapshot PLY, refine,
    videos, final PLY.

Host randomness (cameras, ladders, augmentation flags, flips, as_latent,
densification seeds) comes from the same numpy generators in the same
order as the JAX trainer. Tensor randomness (ladder noise, VAE posterior
eps, SH/scale noise, split samples) is drawn from torch Generators on the
device and passed to the step functions as explicit tensors.

With `mode_args.export_mesh`, `train()` ends by writing `<id>_mesh.ply`
(models/mesh.py). A depth ControlNet conditions the ladder when the
guidance has one (`guidance/sd_loader.build_sd_guidance` with
`guidanceParams.controlnet_model_key`, or `make_tiny_guidance(
with_controlnet=True)`) and `MTSD.use_controlnet` lets it.

With parallelParams dp * tp > 1 the trainer is one rank of a mesh
(parallel/): each rank draws every host and tensor sample of the step, as
a single process would, and `fps_step` renders its cameras' tile bands
(with shard_splats, from its rows of the state), encodes and scores its
cameras and all-reduces the gradients, so every rank ends the step with
the same parameters (or its rows of them). Densify, the importance filter,
capacity growth and the refine phase run on the whole state on every
rank; files are written by rank 0 while the others wait.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from pathlib import Path

import numpy as np
import torch

from dreamscene_tpu_torch.cameras import sampling as S
from dreamscene_tpu_torch.device import resolve_device
from dreamscene_tpu_torch.guidance import mtsd
from dreamscene_tpu_torch.models import densify as D
from dreamscene_tpu_torch.models.gaussians import (
    AdamState,
    GaussianState,
    adam_update,
    create_from_points,
    group_lrs,
    num_active,
    resize,
)
from dreamscene_tpu_torch.models.init import init_object_points
from dreamscene_tpu_torch.models.mesh import export_mesh
from dreamscene_tpu_torch.models.ply import _parse_ply, load_splat_ply, save_splat_ply
from dreamscene_tpu_torch.ops.losses import tv_loss
from dreamscene_tpu_torch.ops.rasterizer import render
from dreamscene_tpu_torch.parallel import collectives as X
from dreamscene_tpu_torch.parallel import distributed as PD
from dreamscene_tpu_torch.parallel import sharded_render as SR
from dreamscene_tpu_torch.rendering import object_render, sample_aug
from dreamscene_tpu_torch.training.capacity import CapacityController
from dreamscene_tpu_torch.training.filtering import importance_filter
from dreamscene_tpu_torch.utils.experiment import setup_experiment_logging
from dreamscene_tpu_torch.utils.media import save_image_grid, write_video
from dreamscene_tpu_torch.utils.profiling import BackwardSpans

logger = logging.getLogger("dreamscene_tpu_torch")

VD_DIRS = ["front", "side", "back", "overhead", "bottom"]
VD_NEG = {
    "front": "side view, back view, overhead view",
    "side": "front view, back view, overhead view",
    "back": "front view, side view, overhead view",
    "overhead": "front view, back view, side view",
    "bottom": "front view, back view, side view, overhead view",
}


def calc_text_embeddings(guidance: mtsd.MTSD, ref_text: str, negative_text: str,
                         opt_params) -> dict:
    """CSD embedding bank: default/uncond/inverse + 5 view-direction
    variants with negated-direction unconds (reference:
    object_trainer.py:152-181)."""
    sp = opt_params.style_prompt
    sn = opt_params.style_negative_prompt
    return {
        "default": guidance.get_text_embeds([f"{ref_text}, {sp}"]),
        "uncond": guidance.get_text_embeds([f"{negative_text}, {sn}"]),
        "inverse_text": guidance.get_text_embeds([guidance.guidance_opt.inverse_text]),
        "text_embeddings_vd": {
            d: guidance.get_text_embeds([f"{ref_text}, {d} view, {sp}"]) for d in VD_DIRS},
        "uncond_text_embeddings_vd": {
            d: guidance.get_text_embeds([f"{negative_text}, {VD_NEG[d]}, {sn}"])
            for d in VD_DIRS},
    }


def get_dir_ind_lr(theta, phi, radius, overhead_threshold=30, front_threshold=75):
    """distinguish_lr=True view classifier (reference: cam_utils.py:66-92)."""
    res = 0
    if -(front_threshold / 2) <= phi < front_threshold / 2:
        res = 0
    if -180 + front_threshold / 2 <= phi < -(front_threshold / 2):
        res = 1
    if phi < -180 + front_threshold / 2 or phi >= 180 - front_threshold / 2:
        res = 2
    if front_threshold / 2 <= phi < 180 - front_threshold / 2:
        res = 3
    if theta < -90 + overhead_threshold:
        res = 4
    if theta >= 90 - overhead_threshold:
        res = 5
    return ["front", "side", "back", "side", "overhead", "bottom", "zoom in"][res]


def assemble_text_embeddings(bank: dict, cameras):
    """[3B, L, D] = [per-view cond | per-view uncond | inverse x B]."""
    pos, unc, vds = [], [], []
    for cam in cameras:
        vd = get_dir_ind_lr(cam.delta_polar, cam.delta_azimuth, cam.delta_radius)
        vds.append(vd)
        pos.append(bank["text_embeddings_vd"][vd][0])
        unc.append(bank["uncond_text_embeddings_vd"][vd][0])
    inv = bank["inverse_text"][0].expand((len(cameras),) + bank["inverse_text"][0].shape)
    return torch.cat([torch.stack(pos), torch.stack(unc), inv], dim=0), vds


def scale_up_camera_ranges(pose_args, optim):
    """In-place progressive widening of the pose ranges (reference:
    object_trainer.py:246-286)."""
    pose_args.fovy_range[0] = max(pose_args.max_fovy_range[0],
                                  pose_args.fovy_range[0] * optim.fovy_scale_up_factor[0])
    pose_args.fovy_range[1] = min(pose_args.max_fovy_range[1],
                                  pose_args.fovy_range[1] * optim.fovy_scale_up_factor[1])
    pose_args.radius_range[1] = max(pose_args.max_radius_range[1],
                                    pose_args.radius_range[1] * optim.scale_up_factor)
    pose_args.radius_range[0] = max(pose_args.max_radius_range[0],
                                    pose_args.radius_range[0] * optim.scale_up_factor)
    pose_args.theta_range[1] = min(pose_args.max_theta_range[1],
                                   pose_args.theta_range[1] * optim.phi_scale_up_factor)
    pose_args.theta_range[0] = max(pose_args.max_theta_range[0],
                                   pose_args.theta_range[0] / optim.phi_scale_up_factor)
    pose_args.phi_range[0] = max(pose_args.max_phi_range[0],
                                 pose_args.phi_range[0] * optim.phi_scale_up_factor)
    pose_args.phi_range[1] = min(pose_args.max_phi_range[1],
                                 pose_args.phi_range[1] * optim.phi_scale_up_factor)


def camera_tensors(cameras, device) -> list[dict]:
    return [dict(viewmatrix=torch.as_tensor(c.world_view_transform, device=device),
                 projmatrix=torch.as_tensor(c.full_proj_transform, device=device),
                 campos=torch.as_tensor(c.camera_center, device=device),
                 tanfovx=c.tanfovx, tanfovy=c.tanfovy) for c in cameras]


def fps_step(state: GaussianState, mods: mtsd.GuidanceModules, cams: list, aug,
             text_emb, ladder, noise, vae_eps, shs_noise, scale_noise, flip: bool,
             as_latent: bool, lrs: dict, *, width: int, height: int, capacity: int,
             active_deg: int, lambda_tv: float, lambda_scale: float,
             guidance_scale: float, lambda_guidance: float, use_cn: bool = False,
             mesh=None) -> dict:
    """One FPS training step (the JAX package's jitted `_fps_step_fn`).

    cams: per-camera dicts of view/proj/campos tensors and tan-fovs;
    aug: [C, 6] host floats (bg rgb, sh drop, shs noise, scale noise);
    noise/vae_eps: [C, h, w, 4]; shs_noise: [C, N, K, 3]; scale_noise:
    [C, N, 3]; use_cn: condition the ladder's UNet passes on the
    ControlNet with the flipped disparity maps as the depth hint. Returns
    the new params/opt/aux, the loss, the peak
    n_entries/n_dropped over the cameras and the raw gradients. The
    phases are marked as fps.* profiler ranges, the backward's parts too:
    `fps.render.bwd` from the gradients of the render's outputs to those
    of its inputs, `fps.vae_encode.bwd` (utils/profiling.BackwardSpans).

    With a `mesh` (parallel/), this rank's part of the step. The
    arguments are the same on every rank (the whole batch); `state` holds
    this rank's rows when it is a tp shard. The rank at (dp_i, tp_i)
    renders the tile band tp_i of cameras [dp_i * b, (dp_i + 1) * b)
    (`make_fps_camera_render`; `capacity` is per band), gathers its dp
    group's bands into full images, and encodes and scores those cameras,
    as every rank of its tp group does alike. Without one, the step runs
    on a 1 x 1 mesh, where every collective is the identity.

    Each term reaches the gradient once: the band gather's backward keeps
    the rank's own band (parallel/collectives.gather_replicated), the mean
    scale term is the share of its rows on the dp rank of the last camera,
    and `tv_loss` divides by the whole batch. The parameter gradients are
    then summed over the mesh (a tp shard's over "dp"), so every rank takes
    the same Adam step. The densification inputs are those of the last
    camera: its probe gradient summed over its bands and broadcast from its
    dp rank. The loss returned is the mesh's sum, each term counted once."""
    # one process renders at the rasterizer's chunk, a mesh at the JAX
    # package's mesh chunk
    mesh, chunk = (SR.single_mesh(), 512) if mesh is None else (mesh, 256)
    c_batch = len(cams)
    shard = state.global_capacity is not None
    mine = SR.rank_cameras(mesh, c_batch)
    b_local = mine.stop - mine.start
    rows = slice(None)
    if shard:
        rows = slice(mesh.coords["tp"] * state.capacity, (mesh.coords["tp"] + 1) * state.capacity)
    tp_group, dp_group = mesh.group("tp"), mesh.group("dp")
    params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
    aux = state.aux
    active = aux["active"]
    probes = torch.zeros((b_local, state.capacity, 2), device=state.device, requires_grad=True)
    render_fn = SR.make_fps_camera_render(mesh, width, height, active_deg, capacity, c_batch,
                                          chunk=chunk, shard_splats=shard)
    q = params["rotation"]
    inputs = dict(xyz=params["xyz"],
                  features=torch.cat([params["features_dc"], params["features_rest"]], dim=1),
                  scaling=torch.exp(params["scaling"]),
                  rotation=q / torch.linalg.norm(q, dim=-1, keepdim=True),
                  opacities=torch.sigmoid(params["opacity"])[:, 0], active=active)
    spans = BackwardSpans()
    with torch.profiler.record_function("fps.render"):
        inputs = spans.end("fps.render.bwd", inputs)
        out = render_fn(inputs, cams[mine], aug[mine], probes, shs_noise[mine][:, rows],
                        scale_noise[mine][:, rows])
        images, depths, scale_share = spans.begin("fps.render.bwd", (
            X.gather_replicated(out["images"], tp_group, dim=2),
            X.gather_replicated(out["disps"], tp_group, dim=2), out["scale_share"]))
    loss_img = (mtsd.guidance_loss(mods, images, depths, flip, as_latent, vae_eps[mine],
                                   noise[mine], ladder, SR.text_rows(text_emb, c_batch, mine),
                                   guidance_scale, lambda_guidance, use_cn, spans=spans)
                + lambda_tv * (tv_loss(images) + tv_loss(depths)) * (b_local / c_batch))
    loss = loss_img + lambda_scale * scale_share
    with torch.profiler.record_function("fps.backward"):
        try:
            loss.backward()
        finally:
            spans.close()

    with torch.profiler.record_function("fps.allreduce"):
        grads = SR.reduce_gradients(
            mesh, {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                   for k, v in params.items()}, shard)
        probe_grad = probes.grad[b_local - 1].clone()
        if not shard:        # a shard's rows already hold every band's part
            X.all_reduce(probe_grad, tp_group)
        X.broadcast(probe_grad, mesh.ranks_of("dp")[-1], dp_group)
        report = loss_img.detach() if mesh.coords["tp"] == 0 else torch.zeros_like(loss_img)
        report = X.all_reduce(report + lambda_scale * out["scale_share"].detach(),
                              mesh.world_group)
    with torch.profiler.record_function("fps.adam"):
        new_params, new_opt = adam_update(state.params, grads, state.opt, active, lrs)
        new_aux = D.update_max_radii(aux, out["radii"], out["visible"])
        new_aux = D.add_densification_stats(new_aux, probe_grad, out["visible"])
    return dict(params=new_params, opt=new_opt, aux=new_aux, loss=report,
                n_entries=out["n_entries"], n_dropped=out["n_dropped"], grads=grads,
                probe_grad=probe_grad)


def recon_step(state: GaussianState, cam: dict, gt_image, lrs: dict, *, width: int,
               height: int, capacity: int, active_deg: int) -> dict:
    """One refine-phase step (the JAX package's jitted `_recon_step_fn`):
    render one reco camera on a black background, loss = 100 *
    mean((image - gt)^2), backward through the rasterizer, masked Adam,
    densification statistics. Returns the new params/opt/aux, the loss
    and the raw gradients. The render, its backward and Adam are the
    `recon.render`, `recon.render.bwd` and `recon.adam` profiler ranges."""
    params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
    active = state.aux["active"]
    probe = torch.zeros((params["xyz"].shape[0], 2), device=state.device, requires_grad=True)
    q = params["rotation"]
    spans = BackwardSpans()
    with torch.profiler.record_function("recon.render"):
        inputs = spans.end("recon.render.bwd", dict(
            means3d=params["xyz"], scales=torch.exp(params["scaling"]),
            quats=q / torch.linalg.norm(q, dim=-1, keepdim=True),
            opacities=torch.sigmoid(params["opacity"])[:, 0],
            shs=torch.cat([params["features_dc"], params["features_rest"]], dim=1)))
        out = render(
            **inputs, **cam, width=width, height=height, bg=torch.zeros(3, device=state.device),
            sh_degree=active_deg, capacity=capacity, means2d_probe=probe, valid_mask=active,
            device=state.device)
        (image,) = spans.begin("recon.render.bwd", (out["image"],))
    loss = 100.0 * torch.mean((image - gt_image) ** 2)
    try:
        loss.backward()
    finally:
        spans.close()
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in params.items()}
    with torch.profiler.record_function("recon.adam"):
        new_params, new_opt = adam_update(state.params, grads, state.opt, active, lrs)
        new_aux = D.update_max_radii(state.aux, out["radii"], out["visibility_filter"])
        new_aux = D.add_densification_stats(new_aux, probe.grad, out["visibility_filter"])
    return dict(params=new_params, opt=new_opt, aux=new_aux, loss=loss.detach(), grads=grads)


class ObjectTrainer:
    """Single-object text-to-3D trainer."""

    def __init__(self, cfg, guidance: mtsd.MTSD | None = None,
                 state: GaussianState | None = None, obj_id: str | None = None,
                 exp_root: str = "experiments", device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.pose_args = cfg.generateCamParams
        self.guidance_opt = cfg.guidanceParams
        self.dataset_args = cfg.modelParams
        self.optim = cfg.optimizationParams
        self.recon_optim = cfg.reconOptimizationParams
        self.obj = cfg.objectParams
        self.id = obj_id or self.obj.id

        exp_name = "default"
        if isinstance(cfg.log, dict):
            exp_name = cfg.log.get("exp_name", "default") or "default"
        self.exp_path = Path(exp_root) / exp_name
        self.ckpt_path = self.exp_path / "checkpoints"
        self.vis_path = self.exp_path / "vis"
        self.ckpt_path.mkdir(parents=True, exist_ok=True)
        self.vis_path.mkdir(parents=True, exist_ok=True)
        # multi-rank mesh (parallelParams: dp cameras x tp tile bands,
        # optionally splat-sharded); None = single process
        par = getattr(cfg, "parallelParams", None)
        self.mesh = None
        self.shard_splats = False
        if par is not None and par.dp * par.tp > 1:
            self.mesh = SR.make_mesh(par.dp, par.tp)
            self.shard_splats = bool(par.shard_splats)
        self.rank0 = PD.rank() == 0
        if self.rank0:
            setup_experiment_logging(self.exp_path, cfg)

        self.rng = np.random.default_rng(cfg.seed)
        self.cameras_extent = self.pose_args.default_radius
        self.step = 0
        self.rec_count = 0
        self.guidance = guidance
        self.last_stats: dict = {}
        self.cap_ctrl = CapacityController()

        if state is not None:
            self.state = state
        else:
            # rank 0 makes (and caches) the init cloud; the others take its
            # arrays (the cached PLY holds uint8 colours)
            pts, cols, sls = PD.from_rank0(lambda: init_object_points(
                self.obj.init_guided, self.obj.init_prompt, str(self.exp_path),
                num_pts=self.obj.num_pts, radius=self.obj.radius,
                use_pointe_rgb=self.obj.use_pointe_rgb, seed=cfg.seed,
                device=self.device))
            cap = min(max(int(pts.shape[0] * 4), 1 << 14), self.optim.max_point_number)
            self.state = create_from_points(pts, cols, sh_degree=self.obj.sh_degree,
                                            capacity=cap, spatial_lr_scale=sls,
                                            device=self.device)

    def _rank0_only(self, fn):
        """fn() on rank 0 alone (files, videos); the others wait."""
        if self.rank0:
            fn()
        if self.mesh is not None:
            PD.barrier()

    def _shard_state(self, state):
        """This rank's rows of `state` with shard_splats (no-op when it is
        sharded already, or whole by design)."""
        if self.mesh is None or not self.shard_splats:
            return state
        return SR.shard_splat_state(self.mesh, state, logger)

    def _whole_state(self, state):
        """Every row of `state` on every rank (densify, filter, refine, files)."""
        if self.mesh is None:
            return state
        return SR.gather_splat_state(self.mesh, state)

    def prepare_train(self):
        # controlnet_model_key is read only by build_sd_guidance, as in JAX
        if self.guidance is None:
            self.guidance = mtsd.make_tiny_guidance(self.guidance_opt, device=self.device)
        self.embeddings = calc_text_embeddings(self.guidance, self.obj.text,
                                               self.obj.negative_text, self.optim)

    def _bg_color(self):
        return (0.0, 0.0, 0.0)

    def _aug_rows(self, c_batch):
        rows = []
        for _ in range(c_batch):
            aug = sample_aug(self.rng, self.dataset_args, self._bg_color())
            rows.append(list(aug.bg_color) + [1.0 if aug.sh_degree_drop else 0.0,
                                              aug.shs_noise, aug.scale_noise])
        return rows

    def step_inputs(self) -> dict:
        """Host side of one step: advance the step count and the schedules,
        sample cameras, ladder, augmentations and the tensor draws, in the
        JAX trainer's order. Returns the keyword arguments of `fps_step`."""
        self.step += 1
        optim = self.optim
        iters = optim.iterations
        self.state = self._shard_state(self.state)
        if self.step % 500 == 0:
            self.state = self.state.one_up_sh_degree()
        st = self.state
        n_rows = st.global_capacity or st.capacity

        if not optim.use_progressive:
            if (self.step >= optim.progressive_view_iter
                    and self.step % optim.scale_up_cameras_iter == 0):
                scale_up_camera_ranges(self.pose_args, optim)

        c_batch = self.guidance_opt.C_batch_size
        avoid_mf = bool((self.cfg.mode_args or {}).get("avoid_multi_face")
                        if isinstance(self.cfg.mode_args, dict) else False)
        if avoid_mf:
            cameras = S.load_random_cam_avoid_multiface(
                self.rng, self.pose_args, self.step / iters, ssaa=True, size=c_batch)
        else:
            cameras = [S.load_random_cam(self.rng, self.pose_args, ssaa=True)
                       for _ in range(c_batch)]

        text_emb, self.last_vds = assemble_text_embeddings(self.embeddings, cameras)
        self.last_cameras = cameras
        as_latent = self.step < optim.geo_iter or self.rng.random() < optim.as_latent_ratio
        g = self.guidance
        ladder = [int(t) for t in g.sample_ladder(min(self.step / iters, 1.0))]
        h, w = self.pose_args.image_h, self.pose_args.image_w
        lat_shape = g.latent_shape(c_batch, h, w)
        noise = g.next_noise(lat_shape)
        lrs = group_lrs(optim, st.spatial_lr_scale, self.step)
        # entry capacity is PER TILE BAND: a band bins ~1/n_tp of the entries
        n_tp = self.mesh.shape["tp"] if self.mesh is not None else 1
        self._n_band = max(n_rows // n_tp, 4096)
        capacity = self.cap_ctrl.capacity(self._n_band)
        aug = self._aug_rows(c_batch)
        # JAX's order on the guidance's generator: ladder, ControlNet gate, flip
        use_cn = g.use_controlnet(self.step, optim)
        flip = g.should_flip()
        k = st.params["features_dc"].shape[1] + st.params["features_rest"].shape[1]
        return dict(
            state=st, mods=g.mods, cams=camera_tensors(cameras, self.device), aug=aug,
            text_emb=text_emb, ladder=ladder, noise=noise,
            vae_eps=g.next_normal(lat_shape),
            shs_noise=g.next_normal((c_batch, n_rows, k, 3)),
            scale_noise=g.next_normal((c_batch, n_rows, 3)),
            flip=flip, as_latent=as_latent, lrs=lrs, width=w, height=h,
            capacity=capacity, active_deg=st.active_sh_degree,
            lambda_tv=optim.lambda_tv, lambda_scale=optim.lambda_scale,
            guidance_scale=self.guidance_opt.guidance_scale,
            lambda_guidance=self.guidance_opt.lambda_guidance, use_cn=use_cn, mesh=self.mesh)

    @torch.profiler.record_function("fps.step")
    def train_step(self) -> float:
        """One FPS step and the cadence around it, as the `fps.step`
        profiler range; the host side of the step is `fps.step_inputs`, the
        host's read of the loss and the entry counts `fps.sync`, the
        guidance visualization every `vis_interval` steps `fps.viz`."""
        with torch.profiler.record_function("fps.step_inputs"):
            inputs = self.step_inputs()
        optim = self.optim
        st = self.state
        res = fps_step(**inputs)
        st.params, st.opt, st.aux = res["params"], res["opt"], res["aux"]
        with torch.profiler.record_function("fps.sync"):
            loss, n_entries, n_dropped = torch.stack(
                [res["loss"].double(), res["n_entries"].double(),
                 res["n_dropped"].double()]).tolist()
        self.last_stats = dict(n_entries=int(n_entries), n_dropped=int(n_dropped),
                               n_rungs=len(inputs["ladder"]), capacity=inputs["capacity"])
        if self.cap_ctrl.update(self._n_band, int(n_entries), int(n_dropped)):
            logger.info("entry capacity multiplier -> %.2fx (entries %d, dropped %d)",
                        self.cap_ctrl.mult, int(n_entries), int(n_dropped))

        if self.step < optim.densify_until_iter:
            if (self.step >= optim.densify_from_iter
                    and self.step % optim.densification_interval == 0):
                # the same host decision on every rank, on the whole state
                self.state = self._whole_state(self.state)
                n0 = num_active(self.state)
                self._densify(optim, 20 if self.step > optim.opacity_reset_interval else None)
                n1 = num_active(self.state)
                logger.debug("densify/prune: %d -> %d", n0, n1)
                if n1 > optim.max_point_number and self.step < 1500:
                    self.gaussian_filtering(self._mode_arg("prune_percent", 0.5))
                self._maybe_grow_capacity()
            if self.step % optim.opacity_reset_interval == 0:
                self.state = D.reset_opacity(self.state)

        if self.step == 1500:
            self.state = self._whole_state(self.state)
            self.gaussian_filtering(0.3)

        # no try/except: a failing kernel in the viz must not be hidden
        if self.step % self.guidance_opt.vis_interval == 0:
            with torch.profiler.record_function("fps.viz"):
                self.save_guidance_viz(self.last_cameras[0], self.last_vds)
        return float(loss)

    def _densify(self, optim, size_thr):
        """densify_and_prune with split samples seeded from the host
        generator, consumed where the JAX trainer draws its key."""
        seed = int(self.rng.integers(0, 2**31))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        eps = torch.randn((self.state.capacity, 2, 3), generator=gen, device=self.device)
        self.state = D.densify_and_prune(self.state, eps, optim.densify_grad_threshold, 0.005,
                                         self.cameras_extent, size_thr, optim.percent_dense)

    @torch.no_grad()
    def save_guidance_viz(self, camera, vds):
        """Per-interval guidance debug grid (reference:
        multitime_sd_utils.py:291-337)."""
        g = self.guidance
        # every rank renders and scores (the guidance's generators advance
        # alike on every rank); rank 0 writes the file
        out = object_render(self._whole_state(self.state), camera, bg_color=self._bg_color())
        images = out["image"][None]
        latents = mtsd.encode_images(
            g.mods, images, g.next_normal(g.latent_shape(1, *images.shape[-2:])))
        ladder = g.sample_ladder(min(self.step / self.optim.iterations, 1.0))
        noise = g.next_noise(tuple(latents.shape))
        text_emb, _ = assemble_text_embeddings(self.embeddings, [camera])
        scores = mtsd.ladder_scores(g.mods, latents, noise, ladder, text_emb)
        grad = mtsd.csd_grad(g.mods, scores, self.guidance_opt.guidance_scale)
        rows = mtsd.guidance_viz_grid(g.mods, images, out["depth"], out["alpha"], latents,
                                      grad, scores, self.guidance_opt.guidance_scale)
        self._rank0_only(lambda: save_image_grid(
            str(self.vis_path / f"{self.id}_iter_{self.step}_vd_{'_'.join(vds)}.jpg"), rows))

    def _mode_arg(self, name, default):
        ma = self.cfg.mode_args or {}
        return ma.get(name, default) if isinstance(ma, dict) else default

    def _maybe_grow_capacity(self):
        st = self.state
        if num_active(st) > 0.9 * st.capacity and st.capacity < self.optim.max_point_number:
            new_cap = min(st.capacity * 2, self.optim.max_point_number)
            logger.info("growing capacity %d -> %d", st.capacity, new_cap)
            self.state = resize(st, new_cap)

    def gaussian_filtering(self, prune_percent):
        """Importance scoring over 48 sphere cameras + percentile prune
        (reference: scene_gaussian.py:1046-1103)."""
        self.state = importance_filter(
            self.state, self.rng, self.pose_args, bg_color=self._bg_color(),
            prune_percent=prune_percent, v_pow=self._mode_arg("v_pow", 0.1),
            prune_decay=self._mode_arg("prune_decay", 0.8))

    def refine_phase(self):
        """Reconstructive generation (reference refine_step + train() phase
        2, object_trainer.py:464-738): pseudo-GT from the 36-view reco rig
        once, then L2*100 per-view updates."""
        optim = self.recon_optim
        g = self.guidance
        g.stage_range = (140, 200)
        g.jump_range = (75, 150)
        # on a mesh every rank refines the whole state alike (the JAX
        # package runs this phase unsharded)
        self.state = self._whole_state(self.state)
        # fresh optimizer step count (the reference re-runs training_setup)
        self.state = dataclasses.replace(
            self.state, opt=AdamState(0, self.state.opt.mu, self.state.opt.nu))
        cams = S.load_reco_cam(self.pose_args, (4, 12, 14, 6), (100, 85, 75, 55), scale=0.9)
        gt_size = len(cams)
        h, w = self.pose_args.image_h, self.pose_args.image_w
        gts = []
        with torch.no_grad():
            for j in range(0, gt_size // 4 * 4, 4):
                chunk = cams[j:j + 4]
                imgs = torch.stack([object_render(self.state, cam, bg_color=self._bg_color())["image"]
                                    for cam in chunk])
                text_emb, _ = assemble_text_embeddings(self.embeddings, chunk)
                ladder = g.sample_ladder(0.0)
                lat_shape = g.latent_shape(len(chunk), h, w)
                noise = g.next_noise(lat_shape)
                latents = mtsd.encode_images(g.mods, imgs, g.next_normal(lat_shape))
                scores = mtsd.ladder_scores(g.mods, latents, noise, ladder, text_emb)
                gts.extend(mtsd.pseudo_gt_images(g.mods, scores,
                                                 self.guidance_opt.guidance_scale).unbind(0))
        self.gt_images = gts

        cam_t = camera_tensors(cams, self.device)
        rec_batch = gt_size // 2
        densify_until = int(optim.iterations * rec_batch * 0.8)
        for it in range(optim.iterations):
            self.step += 1
            if self.step % 300 == 0:
                self.state = self.state.one_up_sh_degree()
            lrs = group_lrs(optim, self.state.spatial_lr_scale, self.step)
            for i in range(rec_batch):
                self.rec_count += 1
                st = self.state
                res = recon_step(st, cam_t[i], self.gt_images[i], lrs, width=w, height=h,
                                 capacity=self.cap_ctrl.capacity(st.capacity),
                                 active_deg=st.active_sh_degree)
                st.params, st.opt, st.aux = res["params"], res["opt"], res["aux"]
                self.last_stats = dict(recon_loss=float(res["loss"]))
                if self.rec_count % 100 == 0:
                    # recon-pair eval render (reference object_trainer.py:654-656)
                    with torch.no_grad():
                        out = object_render(self.state, cams[i], bg_color=self._bg_color())
                    grid = [torch.clamp(out["image"], 0, 1).cpu().numpy(),
                            self.gt_images[i].cpu().numpy()]
                    self._rank0_only(lambda: save_image_grid(
                        str(self.vis_path / f"recon_{self.rec_count}.jpg"), grid))
                if self.rec_count < densify_until:
                    if self.rec_count % optim.densification_interval == 0:
                        self._densify(optim, 20 if self.rec_count > optim.opacity_reset_interval
                                      else None)
                        if num_active(self.state) > optim.max_point_number and it < 25:
                            self.gaussian_filtering(self._mode_arg("prune_percent", 0.5))
                        self._maybe_grow_capacity()
                    if self.rec_count % optim.opacity_reset_interval == 0:
                        self.state = D.reset_opacity(self.state)

    @torch.no_grad()
    def video_inference(self, tag: str):
        """Orbit rgb + depth videos (reference object_trainer.py:81-115),
        rendered and written by rank 0."""
        state = self._whole_state(self.state)
        self._rank0_only(lambda: self._write_videos(state, tag))

    def _write_videos(self, state, tag: str):
        frames, depths, alphas = [], [], []
        for cam in S.load_clip_cam(self.pose_args):
            out = object_render(state, cam, bg_color=(1, 1, 1))
            img = torch.clamp(out["image"], 0, 1).cpu().numpy()
            frames.append((np.transpose(img, (1, 2, 0)) * 255).astype(np.uint8))
            # un-premultiply, as the JAX package does with the disparity
            a = out["alpha"].cpu().numpy()
            depths.append(out["depth"].cpu().numpy() / np.maximum(a, 1e-6))
            alphas.append(a)
        # one normalization window for the whole orbit
        fg = [d[a > 0.5] for d, a in zip(depths, alphas) if (a > 0.5).any()]
        lo = min((f.min() for f in fg), default=0.0)
        hi = max((f.max() for f in fg), default=1.0) + 1e-6
        dframes = [np.repeat((np.clip((d - lo) / (hi - lo), 0, 1) * (a > 0.1) * 255)
                             .astype(np.uint8)[..., None], 3, -1)
                   for d, a in zip(depths, alphas)]
        write_video(str(self.vis_path / f"video_rgb_{self.id}_{tag}.mp4"), frames)
        write_video(str(self.vis_path / f"video_depth_{self.id}_{tag}.mp4"), dframes)

    def save_model(self, tag):
        path = self.ckpt_path / f"{self.id}_{tag}_model.ply"
        state = self._whole_state(self.state)
        self._rank0_only(lambda: save_splat_ply(str(path), state))
        logger.info("saved %s", path)

    def _resume_intermediate(self):
        """Restore the highest `<id>_<step>_model.ply` snapshot and
        fast-forward (reference ckpt_checker, scene_gaussian.py:53-80)."""
        best, best_path = 0, None
        for f in os.listdir(self.ckpt_path):
            parts = f.split("_")
            if (f.endswith("_model.ply") and parts[0] == self.id
                    and parts[1].isdigit() and int(parts[1]) > best):
                best, best_path = int(parts[1]), self.ckpt_path / f
        if best_path is not None:
            logger.info("resuming %s from step %d", self.id, best)
            n = max(_parse_ply(str(best_path))[1].shape[0], 1)
            self.state = load_splat_ply(str(best_path),
                                        capacity=min(4 * n, self.optim.max_point_number),
                                        device=self.device)
            self.step = best

    def train(self, video_every: int = 500, make_videos: bool = False):
        """The whole object: FPS phase (resumable), snapshot, refine,
        videos, final PLY and, with mode_args.export_mesh, the mesh. A
        finished object (its final PLY exists) is loaded and skipped."""
        final = self.ckpt_path / f"{self.id}_final_model.ply"
        if final.exists():
            logger.info("object %s already trained; skipping", self.id)
            self.state = load_splat_ply(str(final), device=self.device)
            return
        self.prepare_train()
        self._resume_intermediate()
        if not self.recon_optim.only_recon_stage:
            for _ in range(self.step, self.optim.iterations):
                self.train_step()
                if make_videos and self.step % video_every == 0:
                    self.video_inference(str(self.step))
            self.save_model(str(self.step))
        self.refine_phase()
        if make_videos:
            self.video_inference("final")
        self.save_model("final")
        if self._mode_arg("export_mesh", False):
            # a coloured mesh out of the trained splats (marching tetrahedra)
            path = str(self.ckpt_path / f"{self.id}_mesh.ply")
            state = self._whole_state(self.state)
            self._rank0_only(lambda: logger.info("mesh export %s: %s", path, export_mesh(
                state, path, resolution=int(self._mode_arg("mesh_resolution", 128)),
                thresh=float(self._mode_arg("mesh_thresh", 1.0)))))
