"""Carry weights and state across from the JAX package.

The inverse of the JAX package's guidance/sd_loader.map_* functions: it
takes the Flax parameter trees of the UNet and the VAE encoder/decoder,
already converted to nested dicts of numpy arrays, and returns torch
state dicts with diffusers keys for guidance/sd_modules.py. Flax conv
kernels are HWIO (torch OIHW), dense kernels [in, out] (torch
[out, in]), norm `scale` is torch `weight`; diffusers up_blocks[k] is the
Flax up_{n_blocks-1-k}.

`gaussian_state` builds a GaussianState from numpy copies of the JAX
GaussianState's params, Adam moments and aux.

Nothing here imports JAX: the caller does the jax -> numpy step.
"""

from __future__ import annotations

import numpy as np
import torch

from dreamscene_tpu_torch.models.gaussians import AdamState, GaussianState


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def _has(tree, path):
    for p in path:
        if not isinstance(tree, dict) or p not in tree:
            return False
        tree = tree[p]
    return True


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


class _Mapper:
    def __init__(self, tree):
        self.tree = tree.get("params", tree)
        self.sd: dict = {}

    def norm(self, path, key):
        self.sd[key + ".weight"] = _t(_get(self.tree, path + ("scale",)))
        self.sd[key + ".bias"] = _t(_get(self.tree, path + ("bias",)))

    def conv(self, path, key):
        self.sd[key + ".weight"] = _t(np.transpose(_get(self.tree, path + ("kernel",)),
                                                   (3, 2, 0, 1)))
        if _has(self.tree, path + ("bias",)):
            self.sd[key + ".bias"] = _t(_get(self.tree, path + ("bias",)))

    def dense(self, path, key):
        self.sd[key + ".weight"] = _t(_get(self.tree, path + ("kernel",)).T)
        if _has(self.tree, path + ("bias",)):
            self.sd[key + ".bias"] = _t(_get(self.tree, path + ("bias",)))

    def resnet(self, prefix, key, temb=True):
        self.norm((prefix, "norm1"), key + ".norm1")
        self.conv((prefix, "conv1"), key + ".conv1")
        if temb:
            self.dense((prefix, "time_emb_proj"), key + ".time_emb_proj")
        self.norm((prefix, "norm2"), key + ".norm2")
        self.conv((prefix, "conv2"), key + ".conv2")
        if _has(self.tree, (prefix, "conv_shortcut")):
            self.conv((prefix, "conv_shortcut"), key + ".conv_shortcut")

    def attn(self, base, key):
        for n in ("to_q", "to_k", "to_v"):
            self.dense(base + (n,), f"{key}.{n}")
        self.dense(base + ("to_out_0",), key + ".to_out.0")

    def spatial_transformer(self, prefix, key):
        self.norm((prefix, "norm"), key + ".norm")
        self.dense((prefix, "proj_in"), key + ".proj_in")
        self.dense((prefix, "proj_out"), key + ".proj_out")
        tb, base = key + ".transformer_blocks.0", (prefix, "transformer_blocks_0")
        self.attn(base + ("attn1",), tb + ".attn1")
        self.attn(base + ("attn2",), tb + ".attn2")
        for n in ("norm1", "norm2", "norm3"):
            self.norm(base + (n,), f"{tb}.{n}")
        self.dense(base + ("ff", "net_0_proj"), tb + ".ff.net.0.proj")
        self.dense(base + ("ff", "net_2"), tb + ".ff.net.2")

    def vae_mid(self, base):
        self.resnet("mid_res_0", base + ".mid_block.resnets.0", temb=False)
        a = base + ".mid_block.attentions.0"
        self.norm(("mid_attn", "group_norm"), a + ".group_norm")
        self.attn(("mid_attn",), a)
        self.resnet("mid_res_1", base + ".mid_block.resnets.1", temb=False)


def unet_state_dict(flax_params: dict, cfg) -> dict:
    """Flax FlaxUNet2DCondition params -> UNet2DCondition state dict."""
    m = _Mapper(flax_params)
    m.conv(("conv_in",), "conv_in")
    m.dense(("time_embedding_linear_1",), "time_embedding.linear_1")
    m.dense(("time_embedding_linear_2",), "time_embedding.linear_2")
    n_blocks = len(cfg.block_out_channels)
    for i in range(n_blocks):
        for j in range(cfg.layers_per_block):
            m.resnet(f"down_{i}_res_{j}", f"down_blocks.{i}.resnets.{j}")
            if cfg.with_cross_attn[i]:
                m.spatial_transformer(f"down_{i}_attn_{j}", f"down_blocks.{i}.attentions.{j}")
        if i < n_blocks - 1:
            m.conv((f"down_{i}_downsample",), f"down_blocks.{i}.downsamplers.0.conv")
    m.resnet("mid_res_0", "mid_block.resnets.0")
    m.spatial_transformer("mid_attn", "mid_block.attentions.0")
    m.resnet("mid_res_1", "mid_block.resnets.1")
    for k in range(n_blocks):
        i = n_blocks - 1 - k
        for j in range(cfg.layers_per_block + 1):
            m.resnet(f"up_{i}_res_{j}", f"up_blocks.{k}.resnets.{j}")
            if cfg.with_cross_attn[i]:
                m.spatial_transformer(f"up_{i}_attn_{j}", f"up_blocks.{k}.attentions.{j}")
        if i > 0:
            m.conv((f"up_{i}_upsample",), f"up_blocks.{k}.upsamplers.0.conv")
    m.norm(("conv_norm_out",), "conv_norm_out")
    m.conv(("conv_out",), "conv_out")
    return m.sd


def vae_encoder_state_dict(flax_params: dict, cfg) -> dict:
    """Flax FlaxVAEEncoder params -> VAEEncoder state dict."""
    m = _Mapper(flax_params)
    m.conv(("conv_in",), "encoder.conv_in")
    for i in range(len(cfg.block_out_channels)):
        for j in range(cfg.layers_per_block):
            m.resnet(f"down_{i}_res_{j}", f"encoder.down_blocks.{i}.resnets.{j}", temb=False)
        if i < len(cfg.block_out_channels) - 1:
            m.conv((f"down_{i}_downsample",), f"encoder.down_blocks.{i}.downsamplers.0.conv")
    m.vae_mid("encoder")
    m.norm(("conv_norm_out",), "encoder.conv_norm_out")
    m.conv(("conv_out",), "encoder.conv_out")
    m.conv(("quant_conv",), "quant_conv")
    return m.sd


def vae_decoder_state_dict(flax_params: dict, cfg) -> dict:
    """Flax FlaxVAEDecoder params -> VAEDecoder state dict."""
    m = _Mapper(flax_params)
    m.conv(("post_quant_conv",), "post_quant_conv")
    m.conv(("conv_in",), "decoder.conv_in")
    m.vae_mid("decoder")
    n_blocks = len(cfg.block_out_channels)
    for k in range(n_blocks):
        i = n_blocks - 1 - k
        for j in range(cfg.layers_per_block + 1):
            m.resnet(f"up_{i}_res_{j}", f"decoder.up_blocks.{k}.resnets.{j}", temb=False)
        if i > 0:
            m.conv((f"up_{i}_upsample",), f"decoder.up_blocks.{k}.upsamplers.0.conv")
    m.norm(("conv_norm_out",), "decoder.conv_norm_out")
    m.conv(("conv_out",), "decoder.conv_out")
    return m.sd


def gaussian_state(params: dict, aux: dict, mu: dict, nu: dict, count: int,
                   sh_degree: int, active_sh_degree: int, spatial_lr_scale: float,
                   device="cpu") -> GaussianState:
    """GaussianState from numpy copies of the JAX state's fields (params,
    Adam moments and aux, keyed by the JAX field names)."""

    def conv(d):
        return {k: torch.tensor(np.asarray(v), device=device) for k, v in d.items()}

    aux_t = conv(aux)
    aux_t["active"] = aux_t["active"].bool()
    return GaussianState(params=conv(params), aux=aux_t,
                         opt=AdamState(count=int(count), mu=conv(mu), nu=conv(nu)),
                         sh_degree=sh_degree, active_sh_degree=active_sh_degree,
                         spatial_lr_scale=spatial_lr_scale)


def guidance_modules(unet_sd: dict, enc_sd: dict, dec_sd: dict, unet_cfg, vae_cfg,
                     device="cpu"):
    """GuidanceModules whose UNet / VAE weights are the given state dicts
    (e.g. from `unet_state_dict` and friends)."""
    from dreamscene_tpu_torch.guidance import mtsd
    from dreamscene_tpu_torch.guidance import sd_modules as sdm
    from dreamscene_tpu_torch.ops.ddim import make_schedule

    mods = []
    for cls, cfg, sd in ((sdm.UNet2DCondition, unet_cfg, unet_sd),
                         (sdm.VAEEncoder, vae_cfg, enc_sd),
                         (sdm.VAEDecoder, vae_cfg, dec_sd)):
        with torch.device(device):
            m = cls(cfg)
        m.load_state_dict(sd, strict=True)
        mods.append(m.requires_grad_(False).eval())
    return mtsd.GuidanceModules(
        unet=mods[0], vae_encoder=mods[1], vae_decoder=mods[2],
        scaling_factor=vae_cfg.scaling_factor, schedule=make_schedule(device=device),
        downscale=2 ** (len(vae_cfg.block_out_channels) - 1))
