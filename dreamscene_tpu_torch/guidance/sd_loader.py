"""Load a local diffusers Stable-Diffusion checkpoint into the port's
guidance stack.

Port of dreamscene_tpu/guidance/sd_loader.py. `guidanceParams.model_key`
names a local directory in diffusers layout (unet/ vae/ text_encoder/
tokenizer/ scheduler/); nothing is downloaded. The port's modules
(guidance/sd_modules.py) carry the diffusers state-dict keys, so each
sub-model loads with `load_state_dict(strict=True)`: a missing or extra
key raises rather than leaving a random weight. The one mapping is SD1.x's
1x1-conv `proj_in` / `proj_out` ([O,I,1,1] -> [O,I]). The text encoder and
tokenizer are the port's own (guidance/clip_text.py), and weights are read
by its own safetensors reader (utils/safetensors.py).
"""

from __future__ import annotations

import json
import logging
import os

import torch

from dreamscene_tpu_torch.device import resolve_device
from dreamscene_tpu_torch.guidance.sd_modules import UNetConfig, VAEConfig
from dreamscene_tpu_torch.utils.safetensors import load_file

logger = logging.getLogger("dreamscene_tpu_torch")


def load_torch_state(folder: str) -> dict:
    """A diffusers sub-model's weights as {key: CPU tensor}: the first of
    diffusion_pytorch_model.safetensors, model.safetensors,
    diffusion_pytorch_model.bin, pytorch_model.bin that exists."""
    for name in ("diffusion_pytorch_model.safetensors", "model.safetensors"):
        p = os.path.join(folder, name)
        if os.path.exists(p):
            return load_file(p)
    for name in ("diffusion_pytorch_model.bin", "pytorch_model.bin"):
        p = os.path.join(folder, name)
        if os.path.exists(p):
            return dict(torch.load(p, map_location="cpu", weights_only=True))
    raise FileNotFoundError(f"no weights found in {folder}")


def unet_config(ucfg_json: dict) -> UNetConfig:
    """UNetConfig from unet/config.json: cross_attention_dim,
    block_out_channels and the heads, whose `attention_head_dim` is a list
    (its common value, else 64), <= 16 (SD1.x: a head COUNT) or a head
    width (sd_loader.py:303-322)."""
    cross_dim = ucfg_json.get("cross_attention_dim", 768)
    head_dim = ucfg_json.get("attention_head_dim", 8)
    boc = tuple(ucfg_json["block_out_channels"])
    if isinstance(head_dim, list):
        return UNetConfig(cross_attention_dim=cross_dim, block_out_channels=boc,
                          attention_head_dim=head_dim[0]
                          if all(h == head_dim[0] for h in head_dim) else 64)
    if head_dim <= 16:
        return UNetConfig(cross_attention_dim=cross_dim, block_out_channels=boc,
                          num_attention_heads=head_dim)
    return UNetConfig(cross_attention_dim=cross_dim, block_out_channels=boc,
                      attention_head_dim=head_dim)


def _linear_projections(sd: dict) -> dict:
    """SD1.x's 1x1-conv proj_in / proj_out weights as linear ones."""
    return {k: (v[:, :, 0, 0] if v.ndim == 4 and (".proj_in." in k or ".proj_out." in k) else v)
            for k, v in sd.items()}


def load_module(module: torch.nn.Module, sd: dict) -> torch.nn.Module:
    module.load_state_dict(_linear_projections(sd), strict=True)
    return module.requires_grad_(False).eval()


def scheduler_config(model_dir: str) -> dict:
    """scheduler/scheduler_config.json's schedule, with the JAX package's
    defaults for what it leaves out (sd_loader.py:333-348)."""
    cfg = {}
    path = os.path.join(model_dir, "scheduler", "scheduler_config.json")
    if os.path.exists(path):
        with open(path) as f:
            cfg = json.load(f)
    return dict(num_train_timesteps=cfg.get("num_train_timesteps", 1000),
                beta_start=cfg.get("beta_start", 0.00085),
                beta_end=cfg.get("beta_end", 0.012),
                beta_schedule=cfg.get("beta_schedule", "scaled_linear"),
                prediction_type=cfg.get("prediction_type", "epsilon"),
                set_alpha_to_one=cfg.get("set_alpha_to_one", False))


def build_sd_guidance(model_dir: str, guidance_opt, device="cuda"):
    """Local diffusers checkpoint dir -> MTSD with its weights, schedule,
    text encoder (with guidanceParams.textual_inversion_path) and, when
    guidanceParams.controlnet_model_key names a directory, its depth
    ControlNet."""
    from dreamscene_tpu_torch.guidance import mtsd
    from dreamscene_tpu_torch.guidance import sd_modules as sdm
    from dreamscene_tpu_torch.guidance.clip_text import make_clip_text_encoder
    from dreamscene_tpu_torch.ops.ddim import make_schedule

    dev = resolve_device(device)
    with open(os.path.join(model_dir, "unet", "config.json")) as f:
        ucfg = unet_config(json.load(f))
    vcfg = VAEConfig()
    with torch.device(dev):
        unet, enc, dec = (sdm.UNet2DCondition(ucfg), sdm.VAEEncoder(vcfg),
                          sdm.VAEDecoder(vcfg))
    load_module(unet, load_torch_state(os.path.join(model_dir, "unet")))
    vae_sd = load_torch_state(os.path.join(model_dir, "vae"))
    enc_keys = ("encoder.", "quant_conv.")
    dec_keys = ("decoder.", "post_quant_conv.")
    extra = sorted(k for k in vae_sd if not k.startswith(enc_keys + dec_keys))
    if extra:
        raise ValueError(f"unexpected VAE keys: {extra[:5]}")
    load_module(enc, {k: v for k, v in vae_sd.items() if k.startswith(enc_keys)})
    load_module(dec, {k: v for k, v in vae_sd.items() if k.startswith(dec_keys)})

    # optional depth ControlNet (reference: lllyasviel/sd-controlnet-depth,
    # multitime_sd_utils.py:88-91)
    cn = None
    cn_dir = getattr(guidance_opt, "controlnet_model_key", None)
    if cn_dir and os.path.isdir(cn_dir):
        with torch.device(dev):
            cn = sdm.ControlNet(ucfg)
        load_module(cn, load_torch_state(cn_dir))
        logger.info("loaded depth ControlNet from %s", cn_dir)

    mods = mtsd.GuidanceModules(
        unet=unet, vae_encoder=enc, vae_decoder=dec, scaling_factor=0.18215,
        schedule=make_schedule(**scheduler_config(model_dir), device=dev), downscale=8,
        controlnet=cn)
    text_encode = make_clip_text_encoder(
        model_dir, textual_inversion_path=getattr(guidance_opt, "textual_inversion_path", None),
        device=dev)
    return mtsd.MTSD(mods=mods, text_encode=text_encode, guidance_opt=guidance_opt,
                     device=dev)
