"""One-command SD-weights validation harness, torch.

    python -m dreamscene_tpu_torch.guidance.validate --model_key /path/to/sd21
    python -m dreamscene_tpu_torch.guidance.validate --tiny        # smoke

Port of dreamscene_tpu/guidance/validate.py. The loader's mapping is
tested against synthetic checkpoints; this harness is the check to run
wherever a real checkpoint directory exists (reference behaviour being
validated: guidance/multitime_sd_utils.py:63-112 load + train_step ladder).
Entry points run on the card unless `--device cpu` is given.

It writes to --out (default sd_validation/):
  * decode_probe.jpg    — VAE-decoded seeded latent (colourful
                          low-frequency blobs for real weights, not noise)
  * roundtrip.jpg       — image -> VAE encode -> decode (expect PSNR > 20
                          dB for real SD weights)
  * ladder_grid.jpg     — one guidance ladder on the test card: latent-RGB
                          preview, |CSD grad| heatmap, per-rung decoded
                          x0-hat (multitime_sd_utils.py:291-337)
  * report.json         — PSNR, grad norm and NaN count, and the UNet's
                          bf16-vs-fp32 max/mean deltas on one call

Expected for real SD2.1-base: roundtrip_psnr_db >= 20, UNet bf16 delta
mean <~2e-2, zero NaNs. Random tiny weights: finite numbers, four files.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from dreamscene_tpu_torch.guidance import mtsd
from dreamscene_tpu_torch.guidance import sd_modules as sdm
from dreamscene_tpu_torch.utils.media import save_image_grid


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
    return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


def _test_card(h, w):
    """Smooth gradient + circle test image [1,3,h,w] in [0,1]."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    r = np.sqrt((x / w - 0.5) ** 2 + (y / h - 0.5) ** 2)
    img = np.stack([x / w, y / h, (r < 0.3).astype(np.float32)], 0)
    return img[None]


def validation_draws(guidance, size: int) -> dict:
    """The harness's three standard-normal draws, from a generator seeded
    0: the probe latent, the VAE posterior eps of the round trip and the
    ladder noise, each [1, size/f, size/f, 4]."""
    f = guidance.mods.downscale
    shape = (1, size // f, size // f, 4)
    gen = torch.Generator(device=guidance.device).manual_seed(0)
    return dict(latent=torch.randn(shape, generator=gen, device=guidance.device),
                posterior_eps=torch.randn(shape, generator=gen, device=guidance.device),
                ladder_noise=mtsd.make_ladder_noise(gen, shape, guidance.device))


def float32_unet(unet: sdm.UNet2DCondition) -> sdm.UNet2DCondition:
    """A float32-compute copy of `unet`, built from its state dict (the
    live module is left as it is)."""
    with torch.device(next(unet.parameters()).device):
        hi = sdm.UNet2DCondition(dataclasses.replace(unet.cfg, dtype=torch.float32))
    hi.load_state_dict(unet.state_dict(), strict=True)
    return hi.requires_grad_(False).eval()


@torch.no_grad()
def run_validation(guidance, out_dir: str, size: int = 512,
                   prompt: str = "a photo of a red apple on a table",
                   draws: dict | None = None) -> dict:
    """Writes the four files to `out_dir` and returns the report. `draws`
    (keys of `validation_draws`) replaces the seeded draws."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    mods = guidance.mods
    dev = guidance.device
    draws = draws or validation_draws(guidance, size)
    report: dict = {}

    # 1. decode a seeded latent
    dec = mtsd.decode_latents(mods, draws["latent"])
    report["decode_finite"] = bool(torch.isfinite(dec).all())
    save_image_grid(str(out / "decode_probe.jpg"), [dec[0].cpu().numpy()])

    # 2. encode->decode round trip
    img = torch.as_tensor(_test_card(size, size), device=dev)
    lat2 = mtsd.encode_images(mods, img, draws["posterior_eps"])
    rec = mtsd.decode_latents(mods, lat2)
    report["roundtrip_psnr_db"] = _psnr(rec.cpu(), img.cpu())
    save_image_grid(str(out / "roundtrip.jpg"), [img[0].cpu().numpy(), rec[0].cpu().numpy()])

    # 3. one guidance ladder on the test card (train_step numerics)
    text = guidance.get_text_embeds([prompt, "", ""])
    ladder = [int(t) for t in guidance.sample_ladder(0.0)]
    if len(ladder) == 0:        # degenerate config: walk one t=0 rung
        ladder = [0]
    scores = mtsd.ladder_scores(mods, lat2, draws["ladder_noise"], ladder, text)
    grad = mtsd.csd_grad(mods, scores, guidance_scale=7.5)
    report["csd_grad_norm"] = float(torch.linalg.norm(grad))
    report["csd_grad_nan"] = int((~torch.isfinite(grad)).sum())
    rows = mtsd.guidance_viz_grid(mods, img, torch.zeros(img.shape[-2:], device=dev),
                                  torch.ones(img.shape[-2:], device=dev), lat2, grad, scores,
                                  guidance_scale=7.5)
    save_image_grid(str(out / "ladder_grid.jpg"), rows)

    # 4. bf16-vs-fp32 UNet numerics delta on one call
    t_b = torch.full((3,), 500, dtype=torch.int32, device=dev)
    inp = torch.cat([lat2] * 3, dim=0).permute(0, 3, 1, 2)
    eps_lo = mods.unet(inp, t_b, text)
    eps_hi = float32_unet(mods.unet)(inp.float(), t_b, text.float())
    d = (eps_lo - eps_hi).abs()
    report["unet_bf16_delta_max"] = float(d.max())
    report["unet_bf16_delta_mean"] = float(d.mean())

    with open(out / "report.json", "w") as fjson:
        json.dump(report, fjson, indent=2)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_key", type=str, default=None,
                    help="local diffusers checkpoint dir")
    ap.add_argument("--tiny", action="store_true",
                    help="random tiny stack (smoke, no weights needed)")
    ap.add_argument("--out", type=str, default="sd_validation")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--prompt", type=str, default="a photo of a red apple on a table")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from dreamscene_tpu_torch.utils.config import GuidanceParams

    gp = GuidanceParams()
    if args.model_key:
        from dreamscene_tpu_torch.guidance.sd_loader import build_sd_guidance

        gp.model_key = args.model_key
        guidance = build_sd_guidance(args.model_key, gp, device=args.device)
    elif args.tiny:
        guidance = mtsd.make_tiny_guidance(gp, downscale=8, device=args.device)
    else:
        raise SystemExit("pass --model_key <dir> or --tiny")

    report = run_validation(guidance, args.out, size=args.size, prompt=args.prompt)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
