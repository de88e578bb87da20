"""Guidance parity: the port's tiny UNet and VAE encoder/decoder, with the
JAX tiny stack's weights carried across by `convert.py`, against the
Flax modules; the ladder, the CSD gradient, the decoded pseudo ground
truth, the guidance viz grid and the prompt embeddings.

Tolerances: module outputs and ladder scores atol 1e-4 (float32 on both
sides; convolution and reduction orders differ); prompt embeddings and
host ladders bit-equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dreamscene_tpu.guidance import mtsd as jm
from dreamscene_tpu.utils.config import GuidanceParams as JGuidanceParams
from dreamscene_tpu_torch import convert
from dreamscene_tpu_torch.guidance import mtsd as tm
from dreamscene_tpu_torch.guidance import sd_modules as sdm
from dreamscene_tpu_torch.utils.config import GuidanceParams

ATOL = 1e-4


def np_tree(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def stacks():
    jg = jm.make_tiny_guidance(JGuidanceParams())
    ucfg, vcfg = sdm.tiny_unet_config(), sdm.tiny_vae_config()
    mods = convert.guidance_modules(
        convert.unet_state_dict(np_tree(jg.mods.unet_params), ucfg),
        convert.vae_encoder_state_dict(np_tree(jg.mods.vae_encode_params), vcfg),
        convert.vae_decoder_state_dict(np_tree(jg.mods.vae_decode_params), vcfg),
        ucfg, vcfg)
    return jg, mods


def test_unet_matches_flax(stacks):
    jg, mods = stacks
    rng = np.random.RandomState(0)
    lat = rng.randn(3, 8, 8, 4).astype(np.float32)
    t = np.array([0, 317, 901], np.int32)
    ctx = rng.randn(3, 4, 32).astype(np.float32)
    ref = jg.mods.unet_apply(jg.mods.unet_params, jnp.asarray(lat), jnp.asarray(t),
                             jnp.asarray(ctx))
    with torch.no_grad():
        got = mods.unet(torch.from_numpy(lat).permute(0, 3, 1, 2), torch.from_numpy(t),
                        torch.from_numpy(ctx)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_vae_encoder_decoder_match_flax(stacks):
    jg, mods = stacks
    rng = np.random.RandomState(1)
    img = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    ref = jg.mods.vae_encode(jg.mods.vae_encode_params, jnp.asarray(img))
    with torch.no_grad():
        got = mods.vae_encoder(torch.from_numpy(img).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)

    lat = rng.randn(2, 8, 8, 4).astype(np.float32)
    ref = jg.mods.vae_decode(jg.mods.vae_decode_params, jnp.asarray(lat))
    with torch.no_grad():
        got = mods.vae_decoder(torch.from_numpy(lat).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_encode_images_matches_given_eps(stacks):
    """The posterior draw enters as an explicit eps: feed JAX's own draw."""
    jg, mods = stacks
    rng = np.random.RandomState(2)
    img = rng.rand(2, 3, 16, 16).astype(np.float32)
    key = jax.random.key(5)
    ref = jm.encode_images(jg.mods, jnp.asarray(img), key)
    eps = jax.random.normal(key, ref.shape, jnp.float32)
    with torch.no_grad():
        got = tm.encode_images(mods, torch.from_numpy(img), torch.from_numpy(np.asarray(eps)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_ladder_and_csd_grad_match(stacks):
    jg, mods = stacks
    rng = np.random.RandomState(3)
    b = 2
    lat = rng.randn(b, 8, 8, 4).astype(np.float32)
    noise = rng.randn(b, 8, 8, 4).astype(np.float32)
    emb = rng.randn(3 * b, 4, 32).astype(np.float32)
    ts = [180, 390, 600]
    ref = jm.ladder_scores(jg.mods, jnp.asarray(lat), jnp.asarray(noise),
                           jnp.asarray(ts, jnp.int32), jnp.asarray(emb), n_rungs=len(ts))
    got = tm.ladder_scores(mods, torch.from_numpy(lat), torch.from_numpy(noise), ts,
                           torch.from_numpy(emb))
    assert len(got) == len(ref) == len(ts) + 1
    for (jt, jtrip, jlat), (tt, ttrip, tlat) in zip(ref, got):
        assert int(jt) == tt
        np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), atol=ATOL)
        for a, c in zip(jtrip, ttrip):
            np.testing.assert_allclose(c.numpy(), np.asarray(a), atol=ATOL)
    jgrad = jm.csd_grad(jg.mods, ref, 7.5, 1.0)
    tgrad = tm.csd_grad(mods, got, 7.5, 1.0)
    scale = float(np.abs(np.asarray(jgrad)).max())
    np.testing.assert_allclose(tgrad.numpy() / scale, np.asarray(jgrad) / scale, atol=ATOL)


def test_prompt_embeddings_and_host_rng_bit_equal():
    jg = jm.make_tiny_guidance(JGuidanceParams())
    tg = tm.make_tiny_guidance(GuidanceParams(), device="cpu")
    prompts = ["a thing, front view, ", "negative, side view, back view", ""]
    np.testing.assert_array_equal(tg.get_text_embeds(prompts).numpy(),
                                  np.asarray(jg.get_text_embeds(prompts)))
    for rate in [0.0, 0.3, 1.0]:
        np.testing.assert_array_equal(tg.sample_ladder(rate), jg.sample_ladder(rate))
        assert tg.should_flip() == jg.should_flip()


def test_decode_pseudo_gt_and_viz_match(stacks):
    jg, mods = stacks
    rng = np.random.default_rng(6)
    b, h = 2, 8
    lat = rng.standard_normal((b, h, h, 4)).astype(np.float32)
    noise = rng.standard_normal((b, h, h, 4)).astype(np.float32)
    text = rng.standard_normal((3 * b, 4, 32)).astype(np.float32)
    ladder = [160, 330]
    np.testing.assert_allclose(tm.decode_latents(mods, torch.from_numpy(lat)).numpy(),
                               np.asarray(jm.decode_latents(jg.mods, jnp.asarray(lat))),
                               atol=ATOL)
    jsc = jm.ladder_scores(jg.mods, jnp.asarray(lat), jnp.asarray(noise),
                           jnp.asarray(ladder, jnp.int32), jnp.asarray(text), n_rungs=2)
    tsc = tm.ladder_scores(mods, torch.from_numpy(lat), torch.from_numpy(noise), ladder,
                           torch.from_numpy(text))
    np.testing.assert_allclose(tm.pseudo_gt_images(mods, tsc, 7.5).numpy(),
                               np.asarray(jm.pseudo_gt_images(jg.mods, jsc, 7.5)), atol=ATOL)
    images = rng.random((b, 3, 2 * h, 2 * h)).astype(np.float32)
    depth, alpha = rng.random((2, 2 * h, 2 * h)).astype(np.float32)
    jgrad = jm.csd_grad(jg.mods, jsc, 7.5)
    trows = tm.guidance_viz_grid(mods, torch.from_numpy(images), torch.from_numpy(depth),
                                 torch.from_numpy(alpha), torch.from_numpy(lat),
                                 torch.from_numpy(np.asarray(jgrad)), tsc, 7.5)
    jrows = jm.guidance_viz_grid(jg.mods, jnp.asarray(images), jnp.asarray(depth),
                                 jnp.asarray(alpha), jnp.asarray(lat), jgrad, jsc, 7.5)
    assert len(trows) == len(jrows) == 8
    for i, (a, w) in enumerate(zip(trows, jrows)):
        np.testing.assert_allclose(a, w, atol=ATOL, err_msg=f"row {i}")
