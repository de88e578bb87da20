"""What several drivers share: sub-seeds, the seeded guidance modules (the
program's or the reference's), the program's guidance object, and the copy
of a step's recorded inputs."""

from __future__ import annotations

import copy

import torch

from benchmark import weights

SUB_SEEDS = {"unet": 1, "vae_encoder": 2, "vae_decoder": 3, "splats": 4}


def sub_seed(seed: int, part: str) -> int:
    return int(seed) * 16 + SUB_SEEDS[part]


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def module_configs(cfg: dict, sdm):
    """UNet and VAE configs of a module file (`sdm`: the program's
    sd_modules or the reference's sd) from the configuration."""
    u = dict(cfg["unet"])
    v = dict(cfg["vae"])
    ucfg = sdm.UNetConfig(**{**u, "block_out_channels": tuple(u["block_out_channels"]),
                             "with_cross_attn": tuple(u["with_cross_attn"]),
                             "dtype": _dtype(u["dtype"])})
    vcfg = sdm.VAEConfig(**{**v, "block_out_channels": tuple(v["block_out_channels"]),
                            "dtype": _dtype(v["dtype"])})
    return ucfg, vcfg


def make_modules(cfg: dict, sdm, seed: int, device, decoder: bool, fp8: bool = False) -> dict:
    """The seeded UNet, VAE encoder (and decoder) of `sdm`, built on the
    meta device and filled in place on `device`: no default initialization
    is run."""
    ucfg, vcfg = module_configs(cfg, sdm)
    parts = {"unet": lambda: sdm.UNet2DCondition(ucfg),
             "vae_encoder": lambda: sdm.VAEEncoder(vcfg)}
    if decoder:
        parts["vae_decoder"] = lambda: sdm.VAEDecoder(vcfg)
    out = {}
    for name, build in parts.items():
        with torch.device("meta"):
            mod = build()
        mod = mod.to_empty(device=device)
        weights.fill_(mod, sub_seed(seed, name), device, fp8=fp8)
        out[name] = mod.requires_grad_(False).eval()
    out["scaling_factor"] = vcfg.scaling_factor
    out["downscale"] = 2 ** (len(vcfg.block_out_channels) - 1)
    return out


def program_guidance(cfg: dict, seed: int, device, guidance_params):
    """The program's MTSD over seeded modules at the configuration's widths,
    with its crc32 text encoder of `token_len` tokens."""
    from dreamscene_tpu_torch.guidance import mtsd
    from dreamscene_tpu_torch.guidance import sd_modules as sdm
    from dreamscene_tpu_torch.ops.ddim import make_schedule

    m = make_modules(cfg, sdm, seed, device, decoder=True)
    mods = mtsd.GuidanceModules(
        unet=m["unet"], vae_encoder=m["vae_encoder"], vae_decoder=m["vae_decoder"],
        scaling_factor=m["scaling_factor"], schedule=make_schedule(device=device),
        downscale=m["downscale"])
    enc = mtsd.crc32_text_encoder(cfg["token_len"], cfg["unet"]["cross_attention_dim"], device)
    return mtsd.MTSD(mods=mods, text_encode=enc, guidance_opt=guidance_params, device=device)


def reference_guidance(cfg: dict, seed: int, device, fp8: bool = False) -> dict:
    """The reference's modules from the same seed (kernels rounded to fp8
    for the control)."""
    from benchmark.reference import ddim as RD
    from benchmark.reference import sd as RS

    m = make_modules(cfg, RS, seed, device, decoder=False, fp8=fp8)
    return dict(unet=m["unet"], vae_encoder=m["vae_encoder"],
                scaling_factor=m["scaling_factor"], schedule=RD.make_schedule(device=device))


def fresh_opt(params: dict) -> dict:
    return {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


def masked(grads: dict, active) -> dict:
    """Gradients as the optimizer takes them: inactive rows zeroed (the
    background is not per row)."""
    return {k: (g * active.reshape((-1,) + (1,) * (g.dim() - 1)).to(g.dtype)
                if k != "background" else g) for k, g in grads.items()}


def clone_inputs(inp: dict) -> dict:
    """The recorded copy of one step's inputs (tensors cloned)."""
    keep = {}
    for k, v in inp.items():
        if k in ("state", "mods", "mesh"):
            continue
        if isinstance(v, torch.Tensor):
            keep[k] = v.detach().clone()
        elif k == "cams":
            keep[k] = [{kk: (vv.clone() if isinstance(vv, torch.Tensor) else vv)
                        for kk, vv in c.items()} for c in v]
        else:
            keep[k] = copy.deepcopy(v)
    return keep


