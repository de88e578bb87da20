"""Stable-Diffusion backbone in torch: UNet2DCondition + AutoencoderKL
encoder/decoder.

Port of dreamscene_tpu/guidance/sd_flax.py. Submodules are named after
the diffusers state-dict keys (down_blocks.{i}.resnets.{j}.conv1, ...,
up_blocks.{k} with k = n_blocks-1-i, encoder.mid_block.attentions.0.to_q,
...), so a diffusers checkpoint's keys would load directly.

Modules work in NCHW. Parameters are float32; each layer computes in the
config's dtype (bf16 for the SD2.1/VAE configs, f32 for the tiny ones) by
casting its input and weights, as the Flax modules do. Normalizations
compute in float32 with epsilon 1e-6 (Flax's default) and round once to
the dtype their consumer reads: a group norm also applies the SiLU that
follows it and, before an attention block's projection, lays its output out
token-major (ops/norms.py: on the card a hand-written kernel, differentiated
from the moments it writes where autograd records). GELU is the tanh
approximation (Flax's default). Attention takes one path per shape and device
(`ops/flash_attention.use_flash_attention`): on the card, every
self-attention of 1024+ tokens whose head dim K4 takes goes through the
K4 flash-attention kernels, in `Attention` and `VAEAttention` alike, and
so in the ControlNet's trunk, which reuses the UNet's classes; CPU
tensors and the shapes the gate refuses (cross-attention, the small
latent levels) take a plain matmul + float32 softmax, as the JAX package
leaves it to XLA. Either core, from the scores (or the K4 call) to the
P.V output, runs inside a `sd.attention` profiler range; the projections
stay outside it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dreamscene_tpu_torch.ops import flash_attention as fa
from dreamscene_tpu_torch.ops import norms

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
    """Group norm computed in float32 (the Flax module promotes to float32),
    then the SiLU that follows it in its holder when `silu`, rounded once to
    `out_dtype`, the dtype its consumer reads; [b, c, h, w], or [b, h*w, c]
    when `tokens` (the input of an attention block's projection)."""

    def __init__(self, groups, ch, out_dtype, silu=False, tokens=False):
        super().__init__(groups, ch, eps=NORM_EPS)
        self.out_dtype, self.silu, self.tokens = out_dtype, silu, tokens

    def forward(self, x):
        return norms.group_norm(x, self.num_groups, self.weight, self.bias, self.eps,
                                self.silu, self.out_dtype, self.tokens)


class LayerNorm(nn.LayerNorm):
    """Layer norm computed in float32, returned in `dtype`."""

    def __init__(self, ch, dtype):
        super().__init__(ch, eps=NORM_EPS)
        self.dt = dtype

    def forward(self, x):
        return norms.layer_norm(x, self.weight, self.bias, self.eps, self.dt)


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
        self.norm1 = GroupNorm(groups, cin, dtype, silu=True)
        self.conv1 = Conv(cin, cout, 3, dtype, padding=1)
        if temb_dim is not None:
            self.time_emb_proj = Linear(temb_dim, cout, dtype)
        self.norm2 = GroupNorm(groups, cout, dtype, silu=True)
        self.conv2 = Conv(cout, cout, 3, dtype, padding=1)
        if cin != cout:
            self.conv_shortcut = Conv(cin, cout, 1, dtype)

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
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
        scale = self.head_dim**-0.5
        with torch.profiler.record_function("sd.attention"):
            if fa.use_flash_attention(n, m, self.head_dim, x.device):
                out = fa.flash_attention(q, k, v, scale).to(self.dt)
            else:
                attn = torch.matmul(q * scale, k.transpose(-1, -2))
                attn = torch.softmax(attn.float(), dim=-1).to(self.dt)
                out = torch.matmul(attn, v)
        return self.to_out[0](out.transpose(1, 2).reshape(b, n, -1))


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
        self.norm = GroupNorm(groups, ch, dtype, tokens=True)
        self.proj_in = Linear(ch, ch, dtype)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(ch, heads, head_dim, context_dim, dtype)])
        self.proj_out = Linear(ch, ch, dtype)

    def forward(self, x, context):
        b, c, h, w = x.shape
        res = x
        y = self.proj_in(self.norm(x))
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


class _UNetTrunk(nn.Module):
    """The time embedding, conv_in, down blocks and mid block that the UNet
    and the ControlNet share (diffusers names)."""

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

        self.skip_ch = [ch0]        # channels of each skip state, in order
        self.down_blocks = nn.ModuleList()
        prev = ch0
        for i, ch in enumerate(boc):
            blk = _Block()
            for j in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock(prev if j == 0 else ch, ch,
                                               cfg.num_groups, dt, temb_dim))
                if cfg.with_cross_attn[i]:
                    blk.attentions.append(self._transformer(ch))
                self.skip_ch.append(ch)
            if i < len(boc) - 1:
                blk.downsamplers = nn.ModuleList(
                    [_Sampler(Conv(ch, ch, 3, dt, stride=2, padding=1))])
                self.skip_ch.append(ch)
            self.down_blocks.append(blk)
            prev = ch

        self.mid_block = _Block()
        self.mid_block.resnets.append(ResnetBlock(boc[-1], boc[-1], cfg.num_groups, dt, temb_dim))
        self.mid_block.attentions.append(self._transformer(boc[-1]))
        self.mid_block.resnets.append(ResnetBlock(boc[-1], boc[-1], cfg.num_groups, dt, temb_dim))

    def _transformer(self, ch):
        cfg = self.cfg
        heads, hdim = cfg.heads_for(ch)
        return SpatialTransformer(ch, heads, hdim, cfg.cross_attention_dim, cfg.num_groups,
                                  cfg.dtype)

    def embed_time(self, timesteps):
        temb = timestep_embedding(timesteps, self.cfg.block_out_channels[0])
        return self.time_embedding.linear_2(F.silu(self.time_embedding.linear_1(temb)))

    def down(self, x, temb, context):
        """The down pass from the conv_in state `x`; returns the last state
        and every skip state (conv_in, each resnet/attention, each
        downsample)."""
        skips = [x]
        for i, blk in enumerate(self.down_blocks):
            for j, res in enumerate(blk.resnets):
                x = res(x, temb)
                if self.cfg.with_cross_attn[i]:
                    x = blk.attentions[j](x, context)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0].conv(x)
                skips.append(x)
        return x, skips

    def mid(self, x, temb, context):
        x = self.mid_block.resnets[0](x, temb)
        x = self.mid_block.attentions[0](x, context)
        return self.mid_block.resnets[1](x, temb)


class UNet2DCondition(_UNetTrunk):
    """SD-style conditional UNet, NCHW.

    `control_res = (down_residuals, mid_residual)` adds ControlNet
    residuals: one per skip state after the down pass, one on the mid state
    (the diffusers down_block_additional_residuals /
    mid_block_additional_residual contract, sd_flax.py:276-291); each is
    cast to the state's dtype before the add."""

    def __init__(self, cfg: UNetConfig):
        super().__init__(cfg)
        dt = cfg.dtype
        boc = list(cfg.block_out_channels)
        temb_dim = boc[0] * 4
        skip_ch = list(self.skip_ch)
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
                    blk.attentions.append(self._transformer(ch))
            if i > 0:
                blk.upsamplers = nn.ModuleList([_Sampler(Conv(ch, ch, 3, dt, padding=1))])
            self.up_blocks.append(blk)

        self.conv_norm_out = GroupNorm(cfg.num_groups, boc[0], torch.float32, silu=True)
        self.conv_out = Conv(boc[0], cfg.out_channels, 3, torch.float32, padding=1)

    def forward(self, latents, timesteps, context, control_res=None):
        """latents [B,Cin,H,W]; timesteps [B]; context [B,L,D] -> eps (f32)."""
        cfg = self.cfg
        temb = self.embed_time(timesteps)
        context = context.to(cfg.dtype)
        x, skips = self.down(self.conv_in(latents), temb, context)
        if control_res is not None:
            down_res, mid_res = control_res
            assert len(down_res) == len(skips), (len(down_res), len(skips))
            skips = [s + r.to(s.dtype) for s, r in zip(skips, down_res)]
        x = self.mid(x, temb, context)
        if control_res is not None:
            x = x + mid_res.to(x.dtype)
        for k, blk in enumerate(self.up_blocks):
            i = len(self.up_blocks) - 1 - k
            for j, res in enumerate(blk.resnets):
                x = res(torch.cat([x, skips.pop()], dim=1), temb)
                if cfg.with_cross_attn[i]:
                    x = blk.attentions[j](x, context)
            if hasattr(blk, "upsamplers"):
                x = F.interpolate(x, scale_factor=2, mode="nearest")
                x = blk.upsamplers[0].conv(x)
        return self.conv_out(self.conv_norm_out(x)).float()


class _CondEmbedding(nn.Module):
    """The hint's 3x3 conv pyramid down to latent resolution (diffusers
    ControlNetConditioningEmbedding): conv_in, then per stride-2 stage a
    same-width conv and a stride-2 conv with symmetric (1,1) padding, then
    conv_out (zero-initialised)."""

    def __init__(self, cin, cout, downscale, dtype):
        super().__init__()
        stages = int(math.log2(downscale))
        chans = (16, 32, 96, 256)[:stages + 1]
        self.conv_in = Conv(cin, chans[0], 3, dtype, padding=1)
        self.blocks = nn.ModuleList()
        for k in range(stages):
            self.blocks.append(Conv(chans[k], chans[k], 3, dtype, padding=1))
            self.blocks.append(Conv(chans[k], chans[k + 1], 3, dtype, stride=2, padding=1))
        self.conv_out = Conv(chans[stages], cout, 3, dtype, padding=1)
        self.conv_out.zero_init = True

    def forward(self, c):
        c = F.silu(self.conv_in(c))
        for conv in self.blocks:
            c = F.silu(conv(c))
        return self.conv_out(c)


class ControlNet(_UNetTrunk):
    """Depth ControlNet (port of sd_flax.py:318-417, diffusers
    ControlNetModel keys): the hint's conditioning embedding is added to
    the conv_in state, the UNet's down and mid trunk runs on it, and
    zero-initialised 1x1 convs (controlnet_down_blocks.{k} after conv_in,
    each resnet and each downsample; controlnet_mid_block) project every
    skip state and the mid state into residuals for
    `UNet2DCondition(control_res=...)`. Untrained, it is an exact no-op.

    latents NCHW [B,4,h,w]; cond NHWC [B, downscale*h, downscale*w, 3] at
    image resolution, as in the JAX package. Returns (down residuals, mid
    residual), NCHW float32."""

    def __init__(self, cfg: UNetConfig, downscale: int = 8):
        super().__init__(cfg)
        dt = cfg.dtype
        self.controlnet_cond_embedding = _CondEmbedding(
            3, cfg.block_out_channels[0], downscale, dt)
        self.controlnet_down_blocks = nn.ModuleList(
            [Conv(ch, ch, 1, dt) for ch in self.skip_ch])
        ch = cfg.block_out_channels[-1]
        self.controlnet_mid_block = Conv(ch, ch, 1, dt)
        for conv in [*self.controlnet_down_blocks, self.controlnet_mid_block]:
            conv.zero_init = True
        zero_init_(self)

    def forward(self, latents, timesteps, context, cond):
        cfg = self.cfg
        temb = self.embed_time(timesteps)
        context = context.to(cfg.dtype)
        x = self.conv_in(latents)
        x = x + self.controlnet_cond_embedding(cond.permute(0, 3, 1, 2))
        x, skips = self.down(x, temb, context)
        down = [zc(s).float() for zc, s in zip(self.controlnet_down_blocks, skips)]
        mid = self.controlnet_mid_block(self.mid(x, temb, context)).float()
        return down, mid


# --------------------------------------------------------------------------
# VAE
# --------------------------------------------------------------------------

class VAEAttention(nn.Module):
    """Single-head spatial self-attention of the VAE mid block."""

    def __init__(self, ch, groups, dtype):
        super().__init__()
        self.group_norm = GroupNorm(groups, ch, dtype, tokens=True)
        self.to_q = Linear(ch, ch, dtype)
        self.to_k = Linear(ch, ch, dtype)
        self.to_v = Linear(ch, ch, dtype)
        self.to_out = nn.ModuleList([Linear(ch, ch, dtype)])
        self.dt = dtype

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        with torch.profiler.record_function("sd.attention"):
            if fa.use_flash_attention(h * w, h * w, c, x.device):
                # single head, head_dim = c; the VAE encoder is differentiated
                # in the FPS step, through the kernels' backward
                y = fa.flash_attention(q[:, None], k[:, None], v[:, None],
                                       c**-0.5)[:, 0].to(self.dt)
            else:
                attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)).float() * c**-0.5,
                                     dim=-1).to(self.dt)
                y = torch.matmul(attn, v)
        y = self.to_out[0](y)
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
        self.conv_norm_out = GroupNorm(cfg.num_groups, boc[-1], torch.float32, silu=True)
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
        return self.conv_out(self.conv_norm_out(x))


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
        self.conv_norm_out = GroupNorm(cfg.num_groups, boc[0], torch.float32, silu=True)
        self.conv_out = Conv(boc[0], 3, 3, torch.float32, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0].conv(F.interpolate(x, scale_factor=2, mode="nearest"))
        return self.conv_out(self.conv_norm_out(x))


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
    return zero_init_(module)


@torch.no_grad()
def zero_init_(module: nn.Module) -> nn.Module:
    """Zero the weights and biases of the layers marked `zero_init` (the
    ControlNet's zero convs and the hint embedding's conv_out, zero at init
    as in sd_flax.py:371-381)."""
    for m in module.modules():
        if getattr(m, "zero_init", False):
            m.weight.zero_()
            m.bias.zero_()
    return module
