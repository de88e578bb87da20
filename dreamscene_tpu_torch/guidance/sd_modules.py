"""Stable-Diffusion backbone in torch: UNet2DCondition + AutoencoderKL
encoder/decoder.

Port of dreamscene_tpu/guidance/sd_flax.py. Submodules are named after
the diffusers state-dict keys (down_blocks.{i}.resnets.{j}.conv1, ...,
up_blocks.{k} with k = n_blocks-1-i, encoder.mid_block.attentions.0.to_q,
...), so a diffusers checkpoint's keys would load directly.

Modules work in NCHW. Parameters are float32; each layer computes in the
config's dtype (bf16 for the SD2.1/VAE configs, f32 for the tiny ones) by
casting its input and weights, as the Flax modules do. Normalizations
compute in float32 with epsilon 1e-6 (Flax's default); GELU is the tanh
approximation (Flax's default). Attention is a plain matmul + float32
softmax, as the JAX package leaves it to XLA by default.

The ControlNet is not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

NORM_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    attention_head_dim: int = 64
    num_attention_heads: int | None = None
    num_groups: int = 32
    with_cross_attn: Sequence[bool] = (True, True, True, False)
    dtype: torch.dtype = torch.bfloat16

    def heads_for(self, ch: int) -> tuple[int, int]:
        if self.num_attention_heads is not None:
            return self.num_attention_heads, ch // self.num_attention_heads
        return ch // self.attention_head_dim, self.attention_head_dim


def sd15_unet_config() -> UNetConfig:
    return UNetConfig(cross_attention_dim=768, num_attention_heads=8)


def sd21_unet_config() -> UNetConfig:
    return UNetConfig(cross_attention_dim=1024, attention_head_dim=64)


def tiny_unet_config() -> UNetConfig:
    return UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                      cross_attention_dim=32, attention_head_dim=16, num_groups=8,
                      with_cross_attn=(True, False), dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 4
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    num_groups: int = 32
    scaling_factor: float = 0.18215
    dtype: torch.dtype = torch.bfloat16


def tiny_vae_config() -> VAEConfig:
    return VAEConfig(block_out_channels=(32, 32), layers_per_block=1, num_groups=8,
                     dtype=torch.float32)


# --------------------------------------------------------------------------
# layers computing in a given dtype
# --------------------------------------------------------------------------

class Conv(nn.Conv2d):
    def __init__(self, cin, cout, k, dtype, stride=1, padding=0):
        super().__init__(cin, cout, k, stride=stride, padding=padding)
        self.dt = dtype

    def forward(self, x):
        return F.conv2d(x.to(self.dt), self.weight.to(self.dt), self.bias.to(self.dt),
                        self.stride, self.padding)


class Linear(nn.Linear):
    def __init__(self, cin, cout, dtype, bias=True):
        super().__init__(cin, cout, bias=bias)
        self.dt = dtype

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dt)
        return F.linear(x.to(self.dt), self.weight.to(self.dt), b)


class GroupNorm(nn.GroupNorm):
    """Float32 group norm (the Flax module promotes to float32)."""

    def __init__(self, groups, ch):
        super().__init__(groups, ch, eps=NORM_EPS)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)


class LayerNorm(nn.LayerNorm):
    """Layer norm computed in float32, returned in `dtype`."""

    def __init__(self, ch, dtype):
        super().__init__(ch, eps=NORM_EPS)
        self.dt = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(self.dt)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding, diffusers convention: [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# --------------------------------------------------------------------------
# UNet
# --------------------------------------------------------------------------

class ResnetBlock(nn.Module):
    def __init__(self, cin, cout, groups, dtype, temb_dim=None):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin)
        self.conv1 = Conv(cin, cout, 3, dtype, padding=1)
        if temb_dim is not None:
            self.time_emb_proj = Linear(temb_dim, cout, dtype)
        self.norm2 = GroupNorm(groups, cout)
        self.conv2 = Conv(cout, cout, 3, dtype, padding=1)
        if cin != cout:
            self.conv_shortcut = Conv(cin, cout, 1, dtype)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    def __init__(self, query_dim, heads, head_dim, dtype, context_dim=None):
        super().__init__()
        inner = heads * head_dim
        kv_dim = context_dim or query_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q = Linear(query_dim, inner, dtype, bias=False)
        self.to_k = Linear(kv_dim, inner, dtype, bias=False)
        self.to_v = Linear(kv_dim, inner, dtype, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, query_dim, dtype)])
        self.dt = dtype

    def forward(self, x, context=None):
        context = x if context is None else context
        b, n, _ = x.shape
        m = context.shape[1]
        q = self.to_q(x).reshape(b, n, self.heads, self.head_dim).transpose(1, 2)
        k = self.to_k(context).reshape(b, m, self.heads, self.head_dim).transpose(1, 2)
        v = self.to_v(context).reshape(b, m, self.heads, self.head_dim).transpose(1, 2)
        attn = torch.matmul(q * self.head_dim**-0.5, k.transpose(-1, -2))
        attn = torch.softmax(attn.float(), dim=-1).to(self.dt)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, -1)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim, inner, dtype):
        super().__init__()
        self.proj = Linear(dim, inner * 2, dtype)

    def forward(self, x):
        a, g = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(g, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim, dtype):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4, dtype), nn.Identity(),
                                  Linear(dim * 4, dim, dtype)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class TransformerBlock(nn.Module):
    def __init__(self, dim, heads, head_dim, context_dim, dtype):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype)
        self.attn1 = Attention(dim, heads, head_dim, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.attn2 = Attention(dim, heads, head_dim, dtype, context_dim=context_dim)
        self.norm3 = LayerNorm(dim, dtype)
        self.ff = FeedForward(dim, dtype)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    def __init__(self, ch, heads, head_dim, context_dim, groups, dtype):
        super().__init__()
        self.norm = GroupNorm(groups, ch)
        self.proj_in = Linear(ch, ch, dtype)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(ch, heads, head_dim, context_dim, dtype)])
        self.proj_out = Linear(ch, ch, dtype)

    def forward(self, x, context):
        b, c, h, w = x.shape
        res = x
        y = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = self.proj_in(y)
        y = self.transformer_blocks[0](y, context)
        y = self.proj_out(y)
        return y.reshape(b, h, w, c).permute(0, 3, 1, 2) + res


class _Sampler(nn.Module):
    """Holds `conv` so the key reads downsamplers.0.conv / upsamplers.0.conv."""

    def __init__(self, conv):
        super().__init__()
        self.conv = conv


class _Block(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()


class UNet2DCondition(nn.Module):
    """SD-style conditional UNet, NCHW."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        boc = list(cfg.block_out_channels)
        ch0 = boc[0]
        temb_dim = ch0 * 4
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = Linear(ch0, temb_dim, dt)
        self.time_embedding.linear_2 = Linear(temb_dim, temb_dim, dt)
        self.conv_in = Conv(cfg.in_channels, ch0, 3, dt, padding=1)

        def st(ch):
            heads, hdim = cfg.heads_for(ch)
            return SpatialTransformer(ch, heads, hdim, cfg.cross_attention_dim,
                                      cfg.num_groups, dt)

        skip_ch = [ch0]
        self.down_blocks = nn.ModuleList()
        prev = ch0
        for i, ch in enumerate(boc):
            blk = _Block()
            for j in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock(prev if j == 0 else ch, ch,
                                               cfg.num_groups, dt, temb_dim))
                if cfg.with_cross_attn[i]:
                    blk.attentions.append(st(ch))
                skip_ch.append(ch)
            if i < len(boc) - 1:
                blk.downsamplers = nn.ModuleList(
                    [_Sampler(Conv(ch, ch, 3, dt, stride=2, padding=1))])
                skip_ch.append(ch)
            self.down_blocks.append(blk)
            prev = ch

        self.mid_block = _Block()
        self.mid_block.resnets.append(ResnetBlock(boc[-1], boc[-1], cfg.num_groups, dt, temb_dim))
        self.mid_block.attentions.append(st(boc[-1]))
        self.mid_block.resnets.append(ResnetBlock(boc[-1], boc[-1], cfg.num_groups, dt, temb_dim))

        self.up_blocks = nn.ModuleList()
        x_ch = boc[-1]
        for k in range(len(boc)):
            i = len(boc) - 1 - k
            ch = boc[i]
            blk = _Block()
            for j in range(cfg.layers_per_block + 1):
                blk.resnets.append(ResnetBlock(x_ch + skip_ch.pop(), ch, cfg.num_groups,
                                               dt, temb_dim))
                x_ch = ch
                if cfg.with_cross_attn[i]:
                    blk.attentions.append(st(ch))
            if i > 0:
                blk.upsamplers = nn.ModuleList([_Sampler(Conv(ch, ch, 3, dt, padding=1))])
            self.up_blocks.append(blk)

        self.conv_norm_out = GroupNorm(cfg.num_groups, boc[0])
        self.conv_out = Conv(boc[0], cfg.out_channels, 3, torch.float32, padding=1)

    def forward(self, latents, timesteps, context):
        """latents [B,Cin,H,W]; timesteps [B]; context [B,L,D] -> eps (f32)."""
        cfg = self.cfg
        dt = cfg.dtype
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0])
        temb = self.time_embedding.linear_1(temb)
        temb = self.time_embedding.linear_2(F.silu(temb))
        x = self.conv_in(latents)
        context = context.to(dt)
        skips = [x]
        for i, blk in enumerate(self.down_blocks):
            for j, res in enumerate(blk.resnets):
                x = res(x, temb)
                if cfg.with_cross_attn[i]:
                    x = blk.attentions[j](x, context)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0].conv(x)
                skips.append(x)
        x = self.mid_block.resnets[0](x, temb)
        x = self.mid_block.attentions[0](x, context)
        x = self.mid_block.resnets[1](x, temb)
        for k, blk in enumerate(self.up_blocks):
            i = len(self.up_blocks) - 1 - k
            for j, res in enumerate(blk.resnets):
                x = res(torch.cat([x, skips.pop()], dim=1), temb)
                if cfg.with_cross_attn[i]:
                    x = blk.attentions[j](x, context)
            if hasattr(blk, "upsamplers"):
                x = F.interpolate(x, scale_factor=2, mode="nearest")
                x = blk.upsamplers[0].conv(x)
        x = F.silu(self.conv_norm_out(x))
        return self.conv_out(x).float()


# --------------------------------------------------------------------------
# VAE
# --------------------------------------------------------------------------

class VAEAttention(nn.Module):
    """Single-head spatial self-attention of the VAE mid block."""

    def __init__(self, ch, groups, dtype):
        super().__init__()
        self.group_norm = GroupNorm(groups, ch)
        self.to_q = Linear(ch, ch, dtype)
        self.to_k = Linear(ch, ch, dtype)
        self.to_v = Linear(ch, ch, dtype)
        self.to_out = nn.ModuleList([Linear(ch, ch, dtype)])
        self.dt = dtype

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)).float() * c**-0.5,
                             dim=-1).to(self.dt)
        y = self.to_out[0](torch.matmul(attn, v))
        return x + y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class _VAEMid(nn.Module):
    def __init__(self, ch, groups, dtype):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(ch, ch, groups, dtype),
                                      ResnetBlock(ch, ch, groups, dtype)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups, dtype)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        dt = cfg.dtype
        boc = list(cfg.block_out_channels)
        self.conv_in = Conv(3, boc[0], 3, dt, padding=1)
        self.down_blocks = nn.ModuleList()
        prev = boc[0]
        for i, ch in enumerate(boc):
            blk = _Block()
            for j in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock(prev if j == 0 else ch, ch, cfg.num_groups, dt))
            if i < len(boc) - 1:
                blk.downsamplers = nn.ModuleList([_Sampler(Conv(ch, ch, 3, dt, stride=2))])
            self.down_blocks.append(blk)
            prev = ch
        self.mid_block = _VAEMid(boc[-1], cfg.num_groups, dt)
        self.conv_norm_out = GroupNorm(cfg.num_groups, boc[-1])
        self.conv_out = Conv(boc[-1], 2 * cfg.latent_channels, 3, torch.float32, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "downsamplers"):
                # asymmetric ((0,1),(0,1)) padding of the Flax/diffusers encoder
                x = blk.downsamplers[0].conv(F.pad(x, (0, 1, 0, 1)))
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAEEncoder(nn.Module):
    """images [B,3,H,W] in [-1,1] -> moments [B,2*latent,h,w] (f32)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.encoder = _Encoder(cfg)
        self.quant_conv = Conv(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1,
                               torch.float32)

    def forward(self, images):
        return self.quant_conv(self.encoder(images)).float()


class _Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        dt = cfg.dtype
        boc = list(cfg.block_out_channels)
        n = len(boc)
        self.conv_in = Conv(cfg.latent_channels, boc[-1], 3, dt, padding=1)
        self.mid_block = _VAEMid(boc[-1], cfg.num_groups, dt)
        self.up_blocks = nn.ModuleList()
        for k in range(n):
            i = n - 1 - k
            ch = boc[i]
            prev = boc[min(i + 1, n - 1)]
            blk = _Block()
            for j in range(cfg.layers_per_block + 1):
                blk.resnets.append(ResnetBlock(prev if j == 0 else ch, ch, cfg.num_groups, dt))
            if i > 0:
                blk.upsamplers = nn.ModuleList([_Sampler(Conv(ch, ch, 3, dt, padding=1))])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(cfg.num_groups, boc[0])
        self.conv_out = Conv(boc[0], 3, 3, torch.float32, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0].conv(F.interpolate(x, scale_factor=2, mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAEDecoder(nn.Module):
    """latents [B,latent,h,w] -> images [B,3,H,W] in [-1,1] (f32)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.post_quant_conv = Conv(cfg.latent_channels, cfg.latent_channels, 1,
                                    torch.float32)
        self.decoder = _Decoder(cfg)

    def forward(self, latents):
        return self.decoder(self.post_quant_conv(latents.float())).float()


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights: conv/linear kernels ~ N(0, 1/fan_in) (the
    variance of Flax's lecun_normal default), biases 0, norms identity."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, fan_in**-0.5, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return module
