"""Formation Pattern Sampling (FPS / MTSD) guidance, torch.

Port of dreamscene_tpu/guidance/mtsd.py (reference:
guidance/multitime_sd_utils.py:44-647):
  * `ladder_scores` — the DDIM-inversion ladder: from t=0 the noise level
    walks up a random timestep ladder, the UNet runs on the
    (cond | uncond | null) triple at every rung and the step uses the null
    prediction. Runs under torch.no_grad() (the JAX step stops its
    gradient), so autograd keeps none of the UNet passes;
  * `csd_grad` — w(alpha_t) * (uncond + s*(cond - uncond) - blank),
    averaged over rungs;
  * `specify_gradient_loss` — sum(latents * grad.detach()).
Latents cross these functions as NHWC [B, h, w, 4] and images as NCHW, as
in the JAX package; the modules run NCHW inside.

Randomness: host draws (ladders, flips) come from numpy
default_rng(noise_seed) in the JAX package's call order; tensor draws
(ladder noise, VAE posterior eps) come from a torch.Generator on the
device and enter the functions as explicit tensors.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable

import numpy as np
import torch

from dreamscene_tpu_torch.device import resolve_device
from dreamscene_tpu_torch.guidance import sd_modules as sdm
from dreamscene_tpu_torch.ops.ddim import (
    DiffusionSchedule,
    add_noise,
    ddim_step,
    make_schedule,
)


@dataclasses.dataclass
class GuidanceModules:
    """SD backbone: modules (NCHW) + schedule."""

    unet: torch.nn.Module          # (latents, t[B], ctx[B,L,D]) -> eps
    vae_encoder: torch.nn.Module   # images in [-1,1] -> moments [B,2C,h,w]
    vae_decoder: torch.nn.Module   # latents -> images in [-1,1]
    scaling_factor: float
    schedule: DiffusionSchedule
    downscale: int = 8


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def encode_images(mods: GuidanceModules, images_nchw, eps):
    """VAE-encode [B,3,H,W] images in [0,1] -> latents [B,h,w,4] with the
    posterior sampled through the given standard-normal `eps` [B,h,w,4]."""
    moments = _nhwc(mods.vae_encoder(images_nchw * 2.0 - 1.0))
    mean, logvar = moments.chunk(2, dim=-1)
    logvar = torch.clamp(logvar, -30.0, 20.0)
    latents = mean + torch.exp(0.5 * logvar) * eps
    return latents * mods.scaling_factor


def make_ladder_noise(generator: torch.Generator, shape, device):
    """randn(latents) + 0.1 * randn per-channel offset shared across the
    batch (multitime_sd_utils.py:205-231)."""
    base = torch.randn(shape, generator=generator, device=device)
    offset = torch.randn((1, 1, 1, shape[-1]), generator=generator, device=device)
    return base + 0.1 * offset


def build_rand_ladder(rng: np.random.Generator, jump_range, stage_range,
                      stage_step_rate: float, max_rungs: int = 4) -> list[int]:
    """Host-side random timestep ladder (multitime_sd_utils.py:239-265)."""
    jump_min, jump_max = int(jump_range[0]), int(jump_range[1])
    stage_step = stage_range[1] - stage_range[0]
    max_step = stage_range[1] - int(stage_step * stage_step_rate)
    rand_list: list[int] = []
    for _ in range(max_rungs):
        jump = int(rng.integers(jump_min, jump_max))
        if not rand_list:
            rand_list.append(jump)
        elif rand_list[-1] + jump < max_step:
            rand_list.append(rand_list[-1] + jump)
        else:
            break
    return rand_list


@torch.no_grad()
def ladder_scores(mods: GuidanceModules, latents, noise, ts, text_emb):
    """DDIM-inversion ladder over t in [0, *ts]; returns a list of
    (t, (cond, uncond, blank), noisy_latent), all NHWC. `ts` are host ints;
    text_emb is [3B, L, D] (cond | uncond | inverse)."""
    b = latents.shape[0]
    dev = latents.device
    lat = add_noise(mods.schedule, latents, noise, torch.zeros((b,), dtype=torch.int32,
                                                                device=dev))
    outs = []
    ts = [int(t) for t in ts]
    t_i = 0
    for i in range(len(ts) + 1):
        if i > 0:
            t_i = ts[i - 1]
        inp = torch.cat([lat, lat, lat], dim=0)
        t_b = torch.full((3 * b,), t_i, dtype=torch.int32, device=dev)
        eps = _nhwc(mods.unet(_nchw(inp), t_b, text_emb))
        cond, uncond, blank = eps.chunk(3, dim=0)
        outs.append((t_i, (cond, uncond, blank), lat))
        if i < len(ts):
            lat, _ = ddim_step(mods.schedule, blank,
                               torch.full((b,), t_i, device=dev), lat, -(ts[i] - t_i))
    return outs


def csd_grad(mods: GuidanceModules, scores, guidance_scale: float,
             grad_scale: float = 1.0):
    """CSD gradient accumulated over the non-zero rungs
    (multitime_sd_utils.py:266-289)."""
    rungs = scores[1:]
    ratio = 1.0 / max(len(rungs), 1)
    ac = mods.schedule.alphas_cumprod
    total = 0.0
    for t_i, (cond, uncond, blank), _ in rungs:
        a = ac[t_i]
        w = torch.sqrt((1.0 - a) / a)
        pred_noise = uncond + guidance_scale * (cond - uncond)
        g = w * (pred_noise - blank)
        total = total + ratio * torch.nan_to_num(grad_scale * g)
    return total


def specify_gradient_loss(latents, grad):
    """loss whose d/d latents == grad (SpecifyGradient)."""
    return (latents * grad.detach()).sum()


def horizontal_flip(flip: bool, *tensors_nchw):
    """Batch-shared horizontal flip (multitime_sd_utils.py:146-162)."""
    return tuple(torch.flip(x, dims=[-1]) if flip else x for x in tensors_nchw)


@dataclasses.dataclass
class MTSD:
    """Host-side orchestration: curriculum state, seeded noise, text
    embeddings (the JAX package's MTSD)."""

    mods: GuidanceModules
    text_encode: Callable      # (list[str]) -> [B, L, D] tensor
    guidance_opt: Any
    device: torch.device
    stage_range: tuple = (400, 850)
    jump_range: tuple = (175, 225)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.guidance_opt.noise_seed)
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(self.guidance_opt.noise_seed))
        self._noise_temp = None

    def get_text_embeds(self, prompts):
        if isinstance(prompts, str):
            prompts = [prompts]
        return self.text_encode(prompts)

    def sample_ladder(self, stage_step_rate: float) -> np.ndarray:
        return np.asarray(build_rand_ladder(self._rng, self.jump_range, self.stage_range,
                                            stage_step_rate), np.int32)

    def latent_shape(self, batch: int, height: int, width: int):
        f = self.mods.downscale
        return (batch, height // f, width // f, 4)

    def next_noise(self, latent_shape):
        """Seeded ladder noise; honors fix_noise."""
        if self.guidance_opt.fix_noise:
            if self._noise_temp is None or tuple(self._noise_temp.shape) != tuple(latent_shape):
                self._noise_temp = make_ladder_noise(self.generator, latent_shape, self.device)
            return self._noise_temp
        return make_ladder_noise(self.generator, latent_shape, self.device)

    def next_normal(self, shape):
        return torch.randn(shape, generator=self.generator, device=self.device)

    def should_flip(self) -> bool:
        return bool(self._rng.random() < 0.5)


def make_tiny_guidance(guidance_opt, seed: int = 0, unet_config=None, vae_config=None,
                       token_len: int = 4, device="cuda") -> MTSD:
    """Seeded random-weight SD stack. Defaults to the miniature configs;
    pass sd21_unet_config() + VAEConfig() for a full-size stack whose
    compute cost is that of real SD weights (BASELINE.json config #2)."""
    dev = resolve_device(device)
    ucfg = unet_config or sdm.tiny_unet_config()
    vcfg = vae_config or sdm.tiny_vae_config()
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        unet = sdm.init_random_(sdm.UNet2DCondition(ucfg), gen)
        enc = sdm.init_random_(sdm.VAEEncoder(vcfg), gen)
        dec = sdm.init_random_(sdm.VAEDecoder(vcfg), gen)
    for m in (unet, enc, dec):
        m.requires_grad_(False).eval()
    mods = GuidanceModules(
        unet=unet, vae_encoder=enc, vae_decoder=dec,
        scaling_factor=vcfg.scaling_factor, schedule=make_schedule(device=dev),
        downscale=2 ** (len(vcfg.block_out_channels) - 1))
    return MTSD(mods=mods, text_encode=crc32_text_encoder(token_len, ucfg.cross_attention_dim,
                                                          dev),
                guidance_opt=guidance_opt, device=dev)


def crc32_text_encoder(token_len: int, dim: int, device):
    """Prompt -> [token_len, dim] embedding drawn from numpy
    default_rng(crc32(prompt) % 2**31): stable across processes, and
    bit-equal to the JAX package's tiny text encoder."""
    cache = {}

    def text_encode(prompts):
        rows = []
        for p in prompts:
            if p not in cache:
                h = zlib.crc32(p.encode("utf-8")) % (2**31)
                cache[p] = np.random.default_rng(h).normal(
                    size=(token_len, dim)).astype(np.float32)
            rows.append(cache[p])
        return torch.as_tensor(np.stack(rows), device=device)

    return text_encode
