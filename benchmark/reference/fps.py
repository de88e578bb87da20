"""One Formation Pattern Sampling step in plain PyTorch: the benchmark's
reference of the object step.

From the step's inputs (cameras, augmentation rows, noise draws, ladder,
text embeddings, learning rates, entry capacity) and the splat parameters:
render each camera through `reference.raster` with the augmented SH and
scales, normalize its disparity, VAE-encode the renders (the disparities
when `as_latent`), walk the DDIM-inversion ladder with the UNet under no
gradient, form the CSD gradient, and back-propagate
sum(latents * sg(grad)) + lambda_tv (tv(images) + tv(disparities)) +
lambda_scale * mean scale into the parameters; then one masked Adam update.
This is the program's step on one process, written out plainly (no mesh,
no kernels, no densification statistics).

`lower=True` computes the rasterizer's records and outputs in bfloat16, the
precision below the configuration's float32, for the control.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import raster as R
from benchmark.reference.ddim import add_noise, ddim_step
from benchmark.reference.projection import project_gaussians

PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity",
                "background")
GROUP_OF_FIELD = {"xyz": "xyz", "features_dc": "f_dc", "features_rest": "f_rest",
                  "scaling": "scaling", "rotation": "rotation", "opacity": "opacity",
                  "background": "background"}


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def encode_images(vae_encoder, scaling_factor, images_nchw, eps):
    moments = _nhwc(vae_encoder(images_nchw * 2.0 - 1.0))
    mean, logvar = moments.chunk(2, dim=-1)
    logvar = torch.clamp(logvar, -30.0, 20.0)
    return (mean + torch.exp(0.5 * logvar) * eps) * scaling_factor


@torch.no_grad()
def ladder_scores(unet, schedule, latents, noise, ts, text_emb):
    b = latents.shape[0]
    dev = latents.device
    lat = add_noise(schedule, latents, noise, torch.zeros((b,), dtype=torch.int32, device=dev))
    outs, t_i = [], 0
    for i in range(len(ts) + 1):
        if i > 0:
            t_i = ts[i - 1]
        t_b = torch.full((3 * b,), t_i, dtype=torch.int32, device=dev)
        eps = _nhwc(unet(_nchw(torch.cat([lat, lat, lat], dim=0)), t_b, text_emb))
        outs.append((t_i, eps.chunk(3, dim=0)))
        if i < len(ts):
            lat, _ = ddim_step(schedule, outs[-1][1][2], torch.full((b,), t_i, device=dev),
                               lat, -(ts[i] - t_i))
    return outs


@torch.no_grad()
def csd_grad(schedule, scores, guidance_scale, grad_scale):
    rungs = scores[1:]
    ratio = 1.0 / max(len(rungs), 1)
    total = 0.0
    for t_i, (cond, uncond, blank) in rungs:
        a = schedule.alphas_cumprod[t_i]
        w = torch.sqrt((1.0 - a) / a)
        g = w * (uncond + guidance_scale * (cond - uncond) - blank)
        total = total + ratio * torch.nan_to_num(grad_scale * g)
    return total


def tv_loss(x):
    b, c, h, w = x.shape
    h_tv = torch.square(x[:, :, 1:, :] - x[:, :, :-1, :]).sum()
    w_tv = torch.square(x[:, :, :, 1:] - x[:, :, :, :-1]).sum()
    return 2.0 * (h_tv / (c * (h - 1) * w) + w_tv / (c * h * (w - 1))) / b


def activated(params):
    """Rasterizer inputs of one model's raw parameters."""
    q = params["rotation"]
    return dict(xyz=params["xyz"],
                features=torch.cat([params["features_dc"], params["features_rest"]], dim=1),
                scaling=torch.exp(params["scaling"]),
                rotation=q / torch.linalg.norm(q, dim=-1, keepdim=True),
                opacities=torch.sigmoid(params["opacity"])[:, 0])


def render_batch(fields, active, inp, lower=False):
    """The step's renders of activated `fields`: images [C,3,H,W],
    normalized disparities [C,1,H,W], and the last camera's scales. Each
    camera's aug row is (bg rgb, SH drop, SH noise, scale noise); the noise
    draws are inp["shs_noise"] / inp["scale_noise"] (None: no noise)."""
    width, height = inp["width"], inp["height"]
    images, disps = [], []
    scales = fields["scaling"]
    for i, cam in enumerate(inp["cams"]):
        a = [float(x) for x in inp["aug"][i]]
        feats = fields["features"]
        shs = torch.cat([feats[:, :1], feats[:, 1:] * (1.0 - a[3])], dim=1)
        scales = fields["scaling"]
        if inp.get("shs_noise") is not None:
            shs = shs + a[4] * inp["shs_noise"][i] * (0.2**0.5) * shs
        if inp.get("scale_noise") is not None:
            scales = torch.clamp_min(scales + a[5] * inp["scale_noise"][i] * (0.2**0.5)
                                     * scales / 4, 0.0)
        splats = project_gaussians(
            fields["xyz"], scales, fields["rotation"], fields["opacities"], shs,
            cam["viewmatrix"], cam["projmatrix"], cam["campos"], cam["tanfovx"],
            cam["tanfovy"], width, height, sh_degree=inp["active_deg"], valid_mask=active)
        if lower:
            splats = splats._replace(**{k: _bf16(getattr(splats, k)) for k in (
                "means2d", "depths", "conics", "colors", "opacities")})
        out = R.render_from_splats(splats, width, height,
                                   torch.tensor(a[:3], dtype=torch.float32,
                                                device=fields["xyz"].device),
                                   capacity=inp["capacity"], chunk=512)
        image, depth, alpha = out["image"], out["depth"], out["alpha"]
        if lower:
            image, depth, alpha = _bf16(image), _bf16(depth), _bf16(alpha)
        focal = 1.0 / (2.0 * cam["tanfovx"])
        disp = focal / (depth + alpha * 10.0 + 1e-5)
        empty = alpha <= 0.1
        any_empty = bool(empty.any())
        min_d = (torch.where(empty, disp, torch.full_like(disp, float("inf"))).min()
                 if any_empty else disp.min())
        max_d = disp.max()
        disp = (disp - min_d) / torch.clamp_min(max_d - min_d, 1e-12)
        disp = torch.minimum(torch.maximum(disp, disp.new_tensor(0.0)), disp.new_tensor(1.0))
        images.append(image)
        disps.append(disp[None])
    return torch.stack(images), torch.stack(disps), scales


def guidance_term(mods, images, depths, inp):
    """latents * sg(CSD gradient) of the flipped renders (the disparities
    when `as_latent`), elementwise: the guidance loss is its sum."""
    if inp["flip"]:
        images, depths = torch.flip(images, dims=[-1]), torch.flip(depths, dims=[-1])
    enc_in = depths.repeat(1, 3, 1, 1) if inp["as_latent"] else images
    latents = encode_images(mods["vae_encoder"], mods["scaling_factor"], enc_in,
                            inp["vae_eps"])
    scores = ladder_scores(mods["unet"], mods["schedule"], latents.detach(), inp["noise"],
                           [int(t) for t in inp["ladder"]], inp["text_emb"])
    grad = csd_grad(mods["schedule"], scores, inp["guidance_scale"], inp["lambda_guidance"])
    return latents * grad.detach()


def loss_and_mass(terms):
    """The loss, the sum of `terms`, and its mass: the sum of the terms'
    magnitudes (the guidance term elementwise), the scale of the loss's
    round-off, since the loss is a sum of both signs that crosses zero."""
    loss = sum(x.sum() for x in terms)
    return loss, float(sum(x.detach().abs().sum() for x in terms))


def step_loss_and_grads(params, active, mods, inp, lower=False):
    """(loss, gradients of every parameter, the loss's mass) of one step."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    images, depths, scales = render_batch(activated(leaves), active, inp, lower)
    share = (scales * active[:, None]).sum() / torch.clamp_min(active.sum().float() * 3.0, 1.0)
    loss, mass = loss_and_mass([guidance_term(mods, images, depths, inp),
                                inp["lambda_tv"] * (tv_loss(images) + tv_loss(depths)),
                                inp["lambda_scale"] * share])
    loss.backward()
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    return loss.detach(), grads, mass


def adam_update(params, grads, opt, active, lrs, b1=0.9, b2=0.999, eps=1e-15):
    """One Adam step with per-group learning rates; inactive rows frozen.
    opt = {"count": int, "mu": {...}, "nu": {...}}."""
    count = opt["count"] + 1
    c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
    c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
    new_p, mu, nu = {}, {}, {}
    for k in PARAM_FIELDS:
        p, g = params[k], grads[k]
        m, v = opt["mu"][k], opt["nu"][k]
        mask = None
        if k != "background":
            mask = active.reshape((-1,) + (1,) * (p.dim() - 1)).to(p.dtype)
            g = g * mask
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        update = (m / c1) / (torch.sqrt(v / c2) + eps)
        if mask is not None:
            update = update * mask
        new_p[k] = p - lrs[GROUP_OF_FIELD[k]] * update
        mu[k], nu[k] = m, v
    return new_p, {"count": count, "mu": mu, "nu": nu}


def fps_step(params, opt, active, mods, inp, lower=False):
    """One step: (loss, gradients, new params, new optimizer state, the
    loss's mass)."""
    loss, grads, mass = step_loss_and_grads(params, active, mods, inp, lower)
    new_p, new_opt = adam_update(params, grads, opt, active, inp["lrs"])
    return loss, grads, new_p, new_opt, mass
