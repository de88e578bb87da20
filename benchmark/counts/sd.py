"""Model FLOPs of the guidance modules at a configuration's widths.

Counted by running the reference modules (`reference/sd.py`, the published
architecture) on the meta device under torch's FlopCounterMode: every
convolution, linear layer and attention product, at 2 FLOPs a
multiply-add; normalizations and elementwise work are not counted. No
memory is touched and nothing runs on a card.
"""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


@functools.lru_cache(maxsize=32)
def _unet_flops(cfg_json: str, batch: int, lat_h: int, lat_w: int) -> int:
    from benchmark.drivers.common import module_configs
    from benchmark.reference import sd

    cfg = json.loads(cfg_json)
    ucfg, _ = module_configs(cfg, sd)
    with torch.device("meta"):
        unet = sd.UNet2DCondition(ucfg)
        x = torch.empty((batch, ucfg.in_channels, lat_h, lat_w))
        t = torch.zeros((batch,), dtype=torch.int32)
        ctx = torch.empty((batch, cfg["token_len"], ucfg.cross_attention_dim))
    return _count(lambda: unet(x, t, ctx))


@functools.lru_cache(maxsize=32)
def _vae_encoder_flops(cfg_json: str, batch: int, h: int, w: int, backward: bool) -> int:
    from benchmark.drivers.common import module_configs
    from benchmark.reference import sd

    cfg = json.loads(cfg_json)
    _, vcfg = module_configs(cfg, sd)
    with torch.device("meta"):
        enc = sd.VAEEncoder(vcfg).requires_grad_(False)
        x = torch.empty((batch, 3, h, w), requires_grad=backward)

    def run():
        y = enc(x)
        if backward:
            y.float().sum().backward()

    return _count(run)


def _key(cfg: dict) -> str:
    return json.dumps({k: cfg[k] for k in ("unet", "vae", "token_len")}, sort_keys=True)


def unet_flops(cfg: dict, batch: int, height: int, width: int) -> int:
    """One UNet pass over `batch` latents of a height x width image."""
    f = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    return _unet_flops(_key(cfg), batch, height // f, width // f)


def vae_encoder_flops(cfg: dict, batch: int, height: int, width: int,
                      backward: bool = False) -> int:
    """The VAE encoder over `batch` images; with `backward`, plus the
    gradient with respect to the images (the weights are frozen)."""
    return _vae_encoder_flops(_key(cfg), batch, height, width, backward)
