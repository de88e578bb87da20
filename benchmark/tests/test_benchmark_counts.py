"""The operation and byte counts, pinned to values worked out by hand at one
shape each, and K1's bound to PERF.md's "bound ms" column at the bench's
shape."""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import manifest, peaks
from benchmark.counts import raster as CR
from benchmark.counts import sd


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_k1_k2_by_hand():
    # 1,000 live entries, 5,000 pairs, 3 live chunks, 4 tiles of 512 px
    acc = 5 * 8 * 512 * 4                     # 4 tiles + the trash tile
    assert CR.k1(1000, 5000, 3, 4, 512) == {
        "ops": 5000 * 27, "bytes": 1000 * 40 + 3 * 16 + acc + 3 * 5 * 512 * 4}
    assert CR.k2(1000, 5000, 3, 4, 512) == {
        "ops": 5000 * 65, "bytes": 1000 * 40 + 3 * 16 + 2 * acc + 3 * 5 * 512 * 4 + 1000 * 40}
    assert CR.sh_ops(2) == 12 + 27 + 54 + 6
    assert CR.splat_ops(10, 0) == {"ops": 3 * 10 * (206 + 12 + 3 + 6 + 6)}


def test_k1_bound_at_the_bench_shape_matches_perf_md():
    """The bench view's counts as the reference binned it on the card
    (seed 3100000057: 1,159,298 live entries, 41,889,708 pairs, 2,580 live
    chunks, 512 tiles of 32 x 16) give K1's bound of PERF.md's kernel table,
    0.0243 ms by bytes. K2's, 0.0406 ms (its operations, its bytes a hair
    below), is lower than the table's 0.0603 ms: the table counted the
    whole grad table that the capacity sizes, this count the live entries'
    gradients."""
    c = dict(live=1_159_298, pairs=41_889_708, live_chunks=2_580, n_tiles=512, tile_pix=512)
    k1 = CR.k1(*c.values())
    ms, by = peaks.least_ms(k1["ops"], k1["bytes"])
    assert by == "bytes" and ms == pytest.approx(0.0243, rel=0.03)
    k2 = CR.k2(*c.values())
    ms2, by2 = peaks.least_ms(k2["ops"], k2["bytes"])
    assert by2 == "operations" and ms2 == pytest.approx(0.0406, rel=0.01)


def test_counter_counts_a_conv_and_an_attention_by_hand():
    from benchmark.reference import sd as RS

    conv = RS.Conv(8, 16, 3, torch.float32, padding=1)
    x = torch.randn(2, 8, 10, 12)
    assert _flops(lambda: conv(x)) == 2 * 2 * 16 * 10 * 12 * 8 * 9
    attn = RS.Attention(32, 2, 16, torch.float32, context_dim=24)
    q, ctx = torch.randn(3, 50, 32), torch.randn(3, 7, 24)
    proj = 2 * 3 * (50 * 32 * 32 + 7 * 24 * 32 * 2 + 50 * 32 * 32)
    products = 2 * 3 * 2 * (50 * 7 * 16) * 2
    assert _flops(lambda: attn(q, ctx)) == proj + products


def test_sd21_counts_at_the_cell_shape():
    """One UNet pass over 12 latents of 64 x 64 with 77 tokens, and the VAE
    encoder over 4 images of 512 x 512, forward and forward + input
    gradient, at SD 2.1's widths (0.80 TFLOP a latent: the known size of
    SD's UNet at 512 x 512)."""
    m = manifest.load()
    cfg = json.loads(manifest.config_file(m, "object_sd21").read_text())
    unet = sd.unet_flops(cfg, 12, 512, 512)
    assert unet / 12 == pytest.approx(0.8043e12, rel=1e-3)
    fwd = sd.vae_encoder_flops(cfg, 4, 512, 512)
    both = sd.vae_encoder_flops(cfg, 4, 512, 512, backward=True)
    assert fwd == pytest.approx(4.4666e12, rel=1e-3)
    assert both == pytest.approx(9.0707e12, rel=1e-3)
