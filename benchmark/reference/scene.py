"""A scene training step and an object's refine step in plain PyTorch: the
benchmark's references of `SceneTrainer`'s stage-1/2 step and of
`recon_step`.

Scene step: the visible models' activated inputs concatenated (SH padded
with zeros to the highest degree), each camera rendered on its background
row, the guidance term of `reference.fps`, lambda_tv tv(images) +
lambda_tv_depth tv(disparities), lambda_scale x the masked mean scale of the
trainable models; backward; one masked Adam update per trainable model.

Refine step: one camera on a black background, loss 100 mean((image -
target)^2), backward, one masked Adam update.
"""

from __future__ import annotations

import torch

from benchmark.reference import fps as RF
from benchmark.reference import raster as R
from benchmark.reference.projection import project_gaussians


def concat(params_list, actives):
    """Activated inputs of several models, concatenated, SH padded."""
    parts = [RF.activated(p) for p in params_list]
    k = max(p["features"].shape[1] for p in parts)
    for p in parts:
        f = p["features"]
        if f.shape[1] < k:
            p["features"] = torch.cat([f, f.new_zeros((f.shape[0], k - f.shape[1], 3))], 1)
    fields = {key: torch.cat([p[key] for p in parts]) for key in parts[0]}
    return fields, torch.cat(actives)


def scene_step(models, trainable, mods, inp, lower=False):
    """models: [{"params", "opt", "active"}] in the step's order. Returns
    (loss, per-model gradients (None where frozen), new models, the loss's
    mass)."""
    leaves = [{k: v.detach().clone().requires_grad_(tr) for k, v in m["params"].items()}
              for m, tr in zip(models, trainable)]
    fields, active = concat(leaves, [m["active"] for m in models])
    aug = [list(bg) + [0.0, 0.0, 0.0] for bg in inp["bg_rows"]]
    images, depths, _ = RF.render_batch(fields, active, {**inp, "aug": aug, "shs_noise": None,
                                                         "scale_noise": None}, lower)
    s_sum, s_cnt = 0.0, 0.0
    for m, p, tr in zip(models, leaves, trainable):
        if tr:
            s_sum = s_sum + (torch.exp(p["scaling"]) * m["active"][:, None]).sum()
            s_cnt = s_cnt + m["active"].sum() * 3.0
    scale_term = inp["lambda_scale"] * s_sum / torch.clamp_min(torch.as_tensor(s_cnt), 1.0)
    loss, mass = RF.loss_and_mass([RF.guidance_term(mods, images, depths, inp),
                                   inp["lambda_tv"] * RF.tv_loss(images),
                                   inp["lambda_tv_depth"] * RF.tv_loss(depths),
                                   torch.as_tensor(scale_term)])
    loss.backward()
    grads, new = [], []
    for m, p, tr, lrs in zip(models, leaves, trainable, inp["lrs_list"]):
        if not tr:
            grads.append(None)
            new.append(m)
            continue
        g = {k: (v.grad if v.grad is not None else torch.zeros_like(v)) for k, v in p.items()}
        new_p, new_opt = RF.adam_update(m["params"], g, m["opt"], m["active"], lrs)
        grads.append(g)
        new.append({"params": new_p, "opt": new_opt, "active": m["active"]})
    return loss.detach(), grads, new, mass


def recon_step(params, opt, active, cam, target, lrs, width, height, capacity, active_deg,
               lower=False):
    """(loss, gradients, new params, new optimizer state) of one refine step."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    f = RF.activated(leaves)
    splats = project_gaussians(f["xyz"], f["scaling"], f["rotation"], f["opacities"],
                               f["features"], cam["viewmatrix"], cam["projmatrix"],
                               cam["campos"], cam["tanfovx"], cam["tanfovy"], width, height,
                               sh_degree=active_deg, valid_mask=active)
    if lower:
        splats = splats._replace(**{k: RF._bf16(getattr(splats, k)) for k in (
            "means2d", "depths", "conics", "colors", "opacities")})
    out = R.render_from_splats(splats, width, height, torch.zeros(3, device=target.device),
                               capacity=capacity, chunk=512)
    image = RF._bf16(out["image"]) if lower else out["image"]
    loss = 100.0 * torch.mean((image - target) ** 2)
    loss.backward()
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    new_p, new_opt = RF.adam_update(params, grads, opt, active, lrs)
    return loss.detach(), grads, new_p, new_opt
