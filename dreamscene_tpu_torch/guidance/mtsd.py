"""Formation Pattern Sampling (FPS / MTSD) guidance, torch.

Port of dreamscene_tpu/guidance/mtsd.py (reference:
guidance/multitime_sd_utils.py:44-647):
  * `ladder_scores` — the DDIM-inversion ladder: from t=0 the noise level
    walks up a random timestep ladder, the UNet runs on the
    (cond | uncond | null) triple at every rung and the step uses the null
    prediction; with a depth hint and a ControlNet loaded, the
    ControlNet's residuals enter every UNet pass. Runs under
    torch.no_grad() (the JAX step stops its gradient), so autograd keeps
    none of the UNet or ControlNet passes;
  * `csd_grad` — w(alpha_t) * (uncond + s*(cond - uncond) - blank),
    averaged over rungs;
  * `specify_gradient_loss` — sum(latents * grad.detach());
  * `pseudo_gt_images` — the decoded x0-hat of the first rung, the
    refine phase's pseudo ground truth; `guidance_viz_grid` — the
    per-interval debug grid;
  * `denoise_ladder` — the reference's CFG denoising walk down a ladder.
Latents cross these functions as NHWC [B, h, w, 4] and images as NCHW, as
in the JAX package; the modules run NCHW inside.

Randomness: host draws (ladders, ControlNet gates, flips) come from numpy
default_rng(noise_seed) in the JAX package's call order; tensor draws
(ladder noise, VAE posterior eps) come from a torch.Generator on the
device and enter the functions as explicit tensors.
"""

from __future__ import annotations

import dataclasses
import functools
import zlib
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from dreamscene_tpu_torch.device import resolve_device
from dreamscene_tpu_torch.guidance import sd_modules as sdm
from dreamscene_tpu_torch.guidance.unet_graph import UNetPasses
from dreamscene_tpu_torch.ops.ddim import (
    DiffusionSchedule,
    add_noise,
    ddim_step,
    make_schedule,
    pred_original,
)
from dreamscene_tpu_torch.utils.profiling import BackwardSpans

# latent -> approximate RGB preview (multitime_sd_utils.py:135-144)
RGB_LATENT_FACTORS = np.array(
    [[0.298, 0.207, 0.208],
     [0.187, 0.286, 0.173],
     [-0.158, 0.189, 0.264],
     [-0.184, -0.271, -0.473]], np.float32)


@dataclasses.dataclass
class GuidanceModules:
    """SD backbone: modules (NCHW) + schedule."""

    unet: torch.nn.Module          # (latents, t[B], ctx[B,L,D]) -> eps
    vae_encoder: torch.nn.Module   # images in [-1,1] -> moments [B,2C,h,w]
    vae_decoder: torch.nn.Module   # latents -> images in [-1,1]
    scaling_factor: float
    schedule: DiffusionSchedule
    downscale: int = 8
    # optional depth ControlNet: (latents, t, ctx, cond_nhwc) ->
    # (down residuals, mid residual) for the UNet's control_res
    controlnet: torch.nn.Module | None = None
    # every UNet pass goes through here: replayed from a CUDA graph on the
    # card, eager elsewhere (guidance/unet_graph.py)
    passes: UNetPasses = dataclasses.field(default_factory=UNetPasses, init=False,
                                           repr=False, compare=False)


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


@torch.no_grad()
def decode_latents(mods: GuidanceModules, latents):
    """latents [B,h,w,4] -> images [B,3,H,W] in [0,1] (reference
    decode_latents, multitime_sd_utils.py:630-637)."""
    x = mods.vae_decoder(_nchw(latents / mods.scaling_factor))
    return torch.clamp(x / 2.0 + 0.5, 0.0, 1.0)


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
def ladder_scores(mods: GuidanceModules, latents, noise, ts, text_emb, cond_image=None):
    """DDIM-inversion ladder over t in [0, *ts]; returns a list of
    (t, (cond, uncond, blank), noisy_latent), all NHWC. `ts` are host ints;
    text_emb is [3B, L, D] (cond | uncond | inverse); cond_image [B, H, W,
    3] NHWC is the ControlNet's depth hint (ignored without a ControlNet)."""
    b = latents.shape[0]
    dev = latents.device
    lat = add_noise(mods.schedule, latents, noise, torch.zeros((b,), dtype=torch.int32,
                                                                device=dev))
    cond3 = _cond3(mods, cond_image)
    outs = []
    ts = [int(t) for t in ts]
    t_i = 0
    for i in range(len(ts) + 1):
        if i > 0:
            t_i = ts[i - 1]
        inp = torch.cat([lat, lat, lat], dim=0)
        t_b = torch.full((3 * b,), t_i, dtype=torch.int32, device=dev)
        eps = _nhwc(_apply_unet(mods, _nchw(inp), t_b, text_emb, cond3))
        cond, uncond, blank = eps.chunk(3, dim=0)
        outs.append((t_i, (cond, uncond, blank), lat))
        if i < len(ts):
            lat, _ = ddim_step(mods.schedule, blank,
                               torch.full((b,), t_i, device=dev), lat, -(ts[i] - t_i))
    return outs


def _cond3(mods: GuidanceModules, cond_image):
    """The hint tiled over the (cond | uncond | inverse) triple; None (or
    no ControlNet loaded) disables conditioning."""
    if cond_image is None or mods.controlnet is None:
        return None
    return torch.cat([cond_image] * 3, dim=0)


def _apply_unet(mods: GuidanceModules, inp, t_b, text_emb, cond3):
    """The UNet on NCHW latents, with the ControlNet's residuals added when
    a hint is given, through the stack's `passes` (replayed from a CUDA
    graph on the card; guidance/unet_graph.py)."""
    modules = (mods.unet,) if cond3 is None else (mods.unet, mods.controlnet)
    return mods.passes(functools.partial(_unet_pass, mods.unet, mods.controlnet), modules,
                       (inp, t_b, text_emb, cond3))


def _unet_pass(unet, controlnet, inp, t_b, text_emb, cond3):
    """One eager pass."""
    if cond3 is None:
        return unet(inp, t_b, text_emb)
    return unet(inp, t_b, text_emb, control_res=controlnet(inp, t_b, text_emb, cond3))


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


def guidance_loss(mods: GuidanceModules, images, depths, flip: bool, as_latent: bool,
                  vae_eps, noise, ladder, text_emb, guidance_scale: float,
                  lambda_guidance: float, use_cn: bool = False, phase: str = "fps", *,
                  spans: BackwardSpans):
    """The guidance term of a training step: flip the renders, VAE-encode
    the images (the disparities with `as_latent`), score the latents on the
    ladder (the flipped disparities as the ControlNet's depth hint with
    `use_cn`) and return sum(latents * sg(CSD gradient)). The encode and
    the ladder are marked as `<phase>.vae_encode` / `<phase>.ladder`
    profiler ranges, and through the step's `spans` the encoder's backward,
    from the gradient of the latents to that of the encoder's input, as
    `<phase>.vae_encode.bwd`."""
    images_f, depths_f = horizontal_flip(flip, images, depths)
    enc_in = depths_f.repeat(1, 3, 1, 1) if as_latent else images_f
    with torch.profiler.record_function(f"{phase}.vae_encode"):
        (enc_in,) = spans.end(f"{phase}.vae_encode.bwd", (enc_in,))
        latents = encode_images(mods, enc_in, vae_eps)
        (latents,) = spans.begin(f"{phase}.vae_encode.bwd", (latents,))
    # depth-ControlNet hint: the flipped disparities, NHWC x 3 channels
    hint = depths_f.permute(0, 2, 3, 1).repeat(1, 1, 1, 3).detach() if use_cn else None
    with torch.profiler.record_function(f"{phase}.ladder"):
        scores = ladder_scores(mods, latents.detach(), noise, ladder, text_emb, cond_image=hint)
        with torch.no_grad():
            grad = csd_grad(mods, scores, guidance_scale, lambda_guidance)
    return specify_gradient_loss(latents, grad)


@torch.no_grad()
def pseudo_gt_images(mods: GuidanceModules, scores, guidance_scale: float):
    """Decoded x0-hat of the first non-zero rung under CFG: the pseudo
    ground truth of the refine phase (train_step_gt,
    multitime_sd_utils.py:446-458)."""
    t_i, (cond, uncond, _), lat = scores[1]
    pred_noise = uncond + guidance_scale * (cond - uncond)
    x0 = pred_original(mods.schedule, pred_noise,
                       torch.full((lat.shape[0],), t_i, device=lat.device), lat)
    return decode_latents(mods, x0)


@torch.no_grad()
def denoise_ladder(mods: GuidanceModules, latents, noise, ts, text_emb, n_rungs: int,
                   cfg: float = 1.0, eta: float = 0.0, is_noisy_latent: bool = False,
                   cond_image=None):
    """The full CFG denoising walk (reference denoise_with_cfg,
    multitime_sd_utils.py:560-628): noise to ts[0] (unless the latents are
    already noisy), then step down the ladder with the CFG-combined
    prediction. Returns the list of (t, (cond, uncond, blank), latent), all
    NHWC, like `ladder_scores`; the last latent is scores[-1][2]. `ts` are
    host ints; no variance noise enters the step, as in the JAX package."""
    b = latents.shape[0]
    dev = latents.device
    ts = [int(t) for t in ts]
    if is_noisy_latent:
        lat = latents
    else:
        lat = add_noise(mods.schedule, latents, noise,
                        torch.full((b,), ts[0], dtype=torch.int32, device=dev))
    cond3 = _cond3(mods, cond_image)
    outs = []
    t_i = ts[0]
    for i in range(n_rungs):
        inp = torch.cat([lat, lat, lat], dim=0)
        t_b = torch.full((3 * b,), t_i, dtype=torch.int32, device=dev)
        eps = _nhwc(_apply_unet(mods, _nchw(inp), t_b, text_emb, cond3))
        cond, uncond, blank = eps.chunk(3, dim=0)
        outs.append((t_i, (cond, uncond, blank), lat))
        if i + 1 < n_rungs:
            pred_noise = uncond + cfg * (cond - uncond)
            lat, _ = ddim_step(mods.schedule, pred_noise, torch.full((b,), t_i, device=dev),
                               lat, t_i - ts[i + 1], eta)
            t_i = ts[i + 1]
    return outs


@torch.no_grad()
def guidance_viz_grid(mods: GuidanceModules, images, depth, alpha, latents, grad, scores,
                      guidance_scale: float):
    """Debug grid like the reference's per-interval dumps
    (multitime_sd_utils.py:291-337): rendered rgb / depth / alpha /
    saturation / latent-RGB preview / |grad| heatmap / decoded x0-hat per
    rung. images [B,3,H,W]; depth/alpha [H,W]; latents/grad [B,h,w,4].
    Returns a list of [3,H,W] numpy arrays for utils.media.save_image_grid."""
    h, w = images.shape[-2:]
    rows = [images[0], depth[None].repeat(3, 1, 1), alpha[None].repeat(3, 1, 1),
            rgb2sat(images[:1])[0].repeat(3, 1, 1)]
    lat_rgb = lat2rgb(latents[0]).permute(2, 0, 1)
    rows.append(F.interpolate(lat_rgb[None], size=(h, w), mode="nearest")[0])
    g = grad[0].abs().mean(-1)
    g = g / torch.clamp_min(g.max(), 1e-8)
    g = F.interpolate(g[None, None], size=(h, w), mode="bilinear", align_corners=False)
    rows.append(g[0].repeat(3, 1, 1))
    for t_i, (cond, uncond, _), lat in scores[1:]:
        pred = uncond + guidance_scale * (cond - uncond)
        x0 = pred_original(mods.schedule, pred,
                           torch.full((lat.shape[0],), t_i, device=lat.device), lat)
        dec = decode_latents(mods, x0[:1])
        if tuple(dec.shape[-2:]) != (h, w):
            dec = F.interpolate(dec, size=(h, w), mode="bilinear", align_corners=False)
        rows.append(dec[0])
    return [r.float().cpu().numpy() for r in rows]


def lat2rgb(latents):
    """Latent -> approximate RGB (reference utils/viz_utils.py:6-12),
    NHWC."""
    factors = torch.as_tensor(RGB_LATENT_FACTORS, device=latents.device)
    return torch.clamp(latents @ factors, 0.0, 1.0)


def rgb2sat(img_nchw, t=None):
    """Saturation map (reference utils/viz_utils.py:15-21)."""
    mx = img_nchw.amax(1, keepdim=True) + 1e-5
    mn = img_nchw.amin(1, keepdim=True)
    sat = (mx - mn) / mx
    if t is not None:
        sat = (1 - t) * sat
    return sat


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

    def use_controlnet(self, step: int, optim_params) -> bool:
        """Host-side depth-ControlNet gate (reference
        training/object_trainer.py:343-348 / scene_trainer.py:835-840):
        step > use_control_net_iter and one `controlnet_ratio` draw from
        `_rng`. False, with no draw, whenever no ControlNet is loaded."""
        if self.mods.controlnet is None:
            return False
        if step <= getattr(optim_params, "use_control_net_iter", 1 << 30):
            return False
        ratio = getattr(self.guidance_opt, "controlnet_ratio", 0.5)
        return bool(self._rng.random() < ratio)


def make_tiny_guidance(guidance_opt, seed: int = 0, unet_config=None, vae_config=None,
                       token_len: int = 4, with_controlnet: bool = False,
                       downscale: int | None = None, device="cuda") -> MTSD:
    """Seeded random-weight SD stack. Defaults to the miniature configs;
    pass sd21_unet_config() + VAEConfig() for a full-size stack whose
    compute cost is that of real SD weights (BASELINE.json config #2).

    with_controlnet adds a ControlNet at the UNet's config, its zero convs
    left at zero (an exact no-op until trained). downscale overrides the
    image -> latent factor of the tiny VAE (log2(downscale) + 1 blocks of
    32 channels, one layer each; 8 gives SD's latent shapes)."""
    dev = resolve_device(device)
    ucfg = unet_config or sdm.tiny_unet_config()
    vcfg = vae_config or sdm.tiny_vae_config()
    if downscale is not None and vae_config is None:
        n_blocks = max(int(np.log2(downscale)), 0) + 1
        vcfg = dataclasses.replace(vcfg, block_out_channels=(32,) * n_blocks,
                                   layers_per_block=1)
    downscale = 2 ** (len(vcfg.block_out_channels) - 1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        unet = sdm.init_random_(sdm.UNet2DCondition(ucfg), gen)
        enc = sdm.init_random_(sdm.VAEEncoder(vcfg), gen)
        dec = sdm.init_random_(sdm.VAEDecoder(vcfg), gen)
        cn = (sdm.init_random_(sdm.ControlNet(ucfg, downscale=downscale), gen)
              if with_controlnet else None)
    for m in (unet, enc, dec, cn):
        if m is not None:
            m.requires_grad_(False).eval()
    mods = GuidanceModules(
        unet=unet, vae_encoder=enc, vae_decoder=dec,
        scaling_factor=vcfg.scaling_factor, schedule=make_schedule(device=dev),
        downscale=downscale, controlnet=cn)
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
