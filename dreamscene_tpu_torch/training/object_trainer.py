"""Object trainer: the Formation Pattern Sampling training step, torch.

Port of dreamscene_tpu/training/object_trainer.py (reference:
training/object_trainer.py:19-738), first slice: `ObjectTrainer.__init__`,
`prepare_train` and `train_step` with the FPS step (`fps_step`):
  * render C_batch cameras through the rasterizer (hand-written kernels
    on the card) with per-camera SH/scale noise augmentation;
  * VAE-encode the renders (or the disparity maps, `as_latent`);
  * the DDIM-inversion UNet ladder (no grad) and the CSD gradient;
  * loss = sum(latents * sg(grad)) + lambda_tv*(tv(img)+tv(disp))
    + lambda_scale * mean scale; backward through the VAE encoder and the
    rasterizer's VJP; masked Adam; densification statistics from the last
    camera (a reference quirk the JAX package keeps).

Host randomness (cameras, ladders, augmentation flags, flips, as_latent)
comes from the same numpy generators in the same order as the JAX
trainer. Tensor randomness (ladder noise, VAE posterior eps, SH/scale
noise) is drawn from the guidance's torch.Generator on the device and
passed to `fps_step` as explicit tensors.

Not ported yet (ROADMAP queue A, slice 2) and raising NotImplementedError
where `train_step` reaches them: densify/prune, opacity reset,
importance filtering (step 1500), guidance visualization; and the
refine phase, PLY save/resume, videos, `train()` and the CLI. The
multi-device mesh raises as well.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from dreamscene_tpu_torch.cameras import sampling as S
from dreamscene_tpu_torch.device import resolve_device
from dreamscene_tpu_torch.guidance import mtsd
from dreamscene_tpu_torch.models import densify as D
from dreamscene_tpu_torch.models.gaussians import (
    GaussianState,
    adam_update,
    create_from_points,
    group_lrs,
)
from dreamscene_tpu_torch.models.init import init_object_points
from dreamscene_tpu_torch.ops.losses import tv_loss
from dreamscene_tpu_torch.ops.rasterizer import render
from dreamscene_tpu_torch.rendering import sample_aug
from dreamscene_tpu_torch.training.capacity import CapacityController
from dreamscene_tpu_torch.utils.experiment import setup_experiment_logging

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


def _clip(x, lo: float, hi: float):
    """jnp.clip as min(max(x, lo), hi): ties at the bounds split the
    gradient like the JAX package's, which torch.clamp does not."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _render_cameras(params: dict, active, cams: list, aug, shs_noise, scale_noise,
                    probes, *, width: int, height: int, capacity: int, active_deg: int):
    """Render every camera with its augmentation; returns stacked images,
    normalized disparities and alphas, the peak entry counts and the last
    camera's radii / visibility / mean scale (the densification inputs)."""
    dev = params["xyz"].device
    c_batch = len(cams)
    images, depths, alphas = [], [], []
    n_entries, n_dropped = [], []
    for i in range(c_batch):
        a = [float(x) for x in aug[i]]
        feats = torch.cat([params["features_dc"], params["features_rest"]], dim=1)
        shs = torch.cat([feats[:, :1], feats[:, 1:] * (1.0 - a[3])], dim=1)
        scales = torch.exp(params["scaling"])
        shs = shs + a[4] * shs_noise[i] * (0.2**0.5) * shs
        scales = torch.clamp_min(scales + a[5] * scale_noise[i] * (0.2**0.5) * scales / 4, 0.0)
        q = params["rotation"]
        out = render(
            means3d=params["xyz"], scales=scales,
            quats=q / torch.linalg.norm(q, dim=-1, keepdim=True),
            opacities=torch.sigmoid(params["opacity"])[:, 0], shs=shs,
            **cams[i], width=width, height=height,
            bg=torch.tensor(a[:3], dtype=torch.float32, device=dev),
            sh_degree=active_deg, capacity=capacity, means2d_probe=probes[i],
            valid_mask=active, device=dev)
        focal = 1.0 / (2.0 * cams[i]["tanfovx"])
        disp = focal / (out["depth"] + out["alpha"] * 10.0 + 1e-5)
        empty = out["alpha"] <= 0.1
        min_d = torch.where(empty.any(),
                            torch.where(empty, disp, torch.full_like(disp, float("inf"))).min(),
                            disp.min())
        # 0/0 guard: an exactly empty view gives max == min
        disp = _clip((disp - min_d) / torch.clamp_min(disp.max() - min_d, 1e-12), 0.0, 1.0)
        images.append(out["image"])
        depths.append(disp[None])
        alphas.append(out["alpha"][None])
        n_entries.append(out["n_entries"])
        n_dropped.append(out["n_dropped"])
    last = dict(radii=out["radii"], visible=out["visibility_filter"],
                scales_mean=(scales * active[:, None]).sum() / (active.sum() * 3.0))
    return (torch.stack(images), torch.stack(depths), torch.stack(alphas),
            torch.stack(n_entries).max(), torch.stack(n_dropped).max(), last)


def fps_step(state: GaussianState, mods: mtsd.GuidanceModules, cams: list, aug,
             text_emb, ladder, noise, vae_eps, shs_noise, scale_noise, flip: bool,
             as_latent: bool, lrs: dict, *, width: int, height: int, capacity: int,
             active_deg: int, lambda_tv: float, lambda_scale: float,
             guidance_scale: float, lambda_guidance: float) -> dict:
    """One FPS training step (the JAX package's jitted `_fps_step_fn`).

    cams: per-camera dicts of view/proj/campos tensors and tan-fovs;
    aug: [C, 6] host floats (bg rgb, sh drop, shs noise, scale noise);
    noise/vae_eps: [C, h, w, 4]; shs_noise: [C, N, K, 3]; scale_noise:
    [C, N, 3]. Returns the new params/opt/aux, the loss, the peak
    n_entries/n_dropped over the cameras and the raw gradients. The
    phases are marked as fps.* profiler ranges."""
    c_batch = len(cams)
    params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
    aux = state.aux
    active = aux["active"]
    probes = torch.zeros((c_batch, params["xyz"].shape[0], 2), device=state.device,
                         requires_grad=True)
    with torch.profiler.record_function("fps.render"):
        images, depths, alphas, n_entries, n_dropped, last = _render_cameras(
            params, active, cams, aug, shs_noise, scale_noise, probes, width=width,
            height=height, capacity=capacity, active_deg=active_deg)
    images_f, depths_f, _ = mtsd.horizontal_flip(flip, images, depths, alphas)
    enc_in = depths_f.repeat(1, 3, 1, 1) if as_latent else images_f
    with torch.profiler.record_function("fps.vae_encode"):
        latents = mtsd.encode_images(mods, enc_in, vae_eps)
    with torch.profiler.record_function("fps.ladder"):
        scores = mtsd.ladder_scores(mods, latents.detach(), noise, ladder, text_emb)
        with torch.no_grad():
            grad = mtsd.csd_grad(mods, scores, guidance_scale, lambda_guidance)
    loss_g = mtsd.specify_gradient_loss(latents, grad)
    loss_tv = tv_loss(images) + tv_loss(depths)
    loss = loss_g + lambda_tv * loss_tv + lambda_scale * last["scales_mean"]
    with torch.profiler.record_function("fps.backward"):
        loss.backward()

    with torch.profiler.record_function("fps.adam"):
        grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                 for k, v in params.items()}
        new_params, new_opt = adam_update(state.params, grads, state.opt, active, lrs)
        new_aux = D.update_max_radii(aux, last["radii"], last["visible"])
        new_aux = D.add_densification_stats(new_aux, probes.grad[c_batch - 1],
                                            last["visible"])
    return dict(params=new_params, opt=new_opt, aux=new_aux, loss=loss.detach(),
                n_entries=n_entries, n_dropped=n_dropped, grads=grads,
                probe_grad=probes.grad[c_batch - 1])


class ObjectTrainer:
    """Single-object text-to-3D trainer (first slice: the FPS step)."""

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
        setup_experiment_logging(self.exp_path, cfg)

        self.rng = np.random.default_rng(cfg.seed)
        self.cameras_extent = self.pose_args.default_radius
        self.step = 0
        self.guidance = guidance
        self.last_stats: dict = {}
        par = getattr(cfg, "parallelParams", None)
        if par is not None and par.dp * par.tp > 1:
            raise NotImplementedError(
                "multi-device training (parallelParams dp*tp > 1) is not ported "
                "yet: ROADMAP queue A, multi-GPU parallel/")
        self.cap_ctrl = CapacityController()

        if state is not None:
            self.state = state
        else:
            pts, cols, sls = init_object_points(
                self.obj.init_guided, self.obj.init_prompt, str(self.exp_path),
                num_pts=self.obj.num_pts, radius=self.obj.radius,
                use_pointe_rgb=self.obj.use_pointe_rgb, seed=cfg.seed)
            cap = min(max(int(pts.shape[0] * 4), 1 << 14), self.optim.max_point_number)
            self.state = create_from_points(pts, cols, sh_degree=self.obj.sh_degree,
                                            capacity=cap, spatial_lr_scale=sls,
                                            device=self.device)

    def prepare_train(self):
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
        if self.step % 500 == 0:
            self.state = self.state.one_up_sh_degree()
        st = self.state

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

        text_emb, _ = assemble_text_embeddings(self.embeddings, cameras)
        as_latent = self.step < optim.geo_iter or self.rng.random() < optim.as_latent_ratio
        g = self.guidance
        ladder = [int(t) for t in g.sample_ladder(min(self.step / iters, 1.0))]
        h, w = self.pose_args.image_h, self.pose_args.image_w
        lat_shape = g.latent_shape(c_batch, h, w)
        noise = g.next_noise(lat_shape)
        lrs = group_lrs(optim, st.spatial_lr_scale, self.step)
        self._n_band = max(st.capacity, 4096)
        capacity = self.cap_ctrl.capacity(self._n_band)
        aug = self._aug_rows(c_batch)
        flip = g.should_flip()
        k = st.params["features_dc"].shape[1] + st.params["features_rest"].shape[1]
        return dict(
            state=st, mods=g.mods, cams=camera_tensors(cameras, self.device), aug=aug,
            text_emb=text_emb, ladder=ladder, noise=noise,
            vae_eps=g.next_normal(lat_shape),
            shs_noise=g.next_normal((c_batch, st.capacity, k, 3)),
            scale_noise=g.next_normal((c_batch, st.capacity, 3)),
            flip=flip, as_latent=as_latent, lrs=lrs, width=w, height=h,
            capacity=capacity, active_deg=st.active_sh_degree,
            lambda_tv=optim.lambda_tv, lambda_scale=optim.lambda_scale,
            guidance_scale=self.guidance_opt.guidance_scale,
            lambda_guidance=self.guidance_opt.lambda_guidance)

    def train_step(self) -> float:
        inputs = self.step_inputs()
        optim = self.optim
        st = self.state
        res = fps_step(**inputs)
        st.params, st.opt, st.aux = res["params"], res["opt"], res["aux"]
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
                raise NotImplementedError(
                    "densify/prune is not ported yet: ROADMAP queue A, slice 2")
            if self.step % optim.opacity_reset_interval == 0:
                raise NotImplementedError(
                    "opacity reset is not ported yet: ROADMAP queue A, slice 2")
        if self.step == 1500:
            raise NotImplementedError(
                "gaussian_filtering (importance prune) is not ported yet: "
                "ROADMAP queue A, slice 2")
        if self.step % self.guidance_opt.vis_interval == 0:
            raise NotImplementedError(
                "guidance visualization is not ported yet: ROADMAP queue A, slice 3")
        return float(loss)
