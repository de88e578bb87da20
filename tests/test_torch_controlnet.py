"""The depth ControlNet: the port's `ControlNet`, the UNet's
`control_res` input, `ladder_scores(cond_image=)`, the tiny stack's
zero-init no-op and the `use_controlnet` gate, against the JAX package's
FlaxControlNet / FlaxUNet2DCondition / mtsd on the tiny float32 config,
with the JAX weights carried across by `convert.py` and the zero convs and
the hint embedding's conv_out filled with seeded non-zero values (at zero
the residuals would be zero on both sides and prove nothing).

Tolerances: residuals, eps and ladder scores atol 1e-4 (float32 on both
sides, as tests/test_torch_guidance.py); the no-op and the gate's draws
exact.
"""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dreamscene_tpu.guidance import mtsd as jm
from dreamscene_tpu.utils.config import GuidanceParams as JGuidanceParams
from dreamscene_tpu.utils.config import OptimizationParams as JOptimizationParams
from dreamscene_tpu_torch import convert
from dreamscene_tpu_torch.guidance import mtsd as tm
from dreamscene_tpu_torch.guidance import sd_modules as sdm
from dreamscene_tpu_torch.utils.config import GuidanceParams, OptimizationParams

torch.set_num_threads(1)

ATOL = 1e-4
ZERO_INIT = re.compile(r"^(ctrl_down_\d+|ctrl_mid|cond_out)$")


def np_tree(t):
    return jax.tree.map(np.asarray, t)


def fill_zero_convs(cn_params, seed=0, scale=0.2):
    """The ControlNet's zero-initialised layers given seeded non-zero
    weights, so that its residuals reach the UNet."""
    rng = np.random.RandomState(seed)
    p = np_tree(cn_params)
    for name, layer in p["params"].items():
        if ZERO_INIT.match(name):
            for k in layer:
                layer[k] = (scale * rng.randn(*layer[k].shape)).astype(np.float32)
    return jax.tree.map(jnp.asarray, p)


def jax_cn_guidance(seed=0):
    """The JAX tiny stack with a ControlNet whose zero convs are filled."""
    jg = jm.make_tiny_guidance(JGuidanceParams(), with_controlnet=True, seed=seed)
    jg.mods = jg.mods._replace(controlnet_params=fill_zero_convs(jg.mods.controlnet_params))
    return jg


def port_mods(jmods):
    """The port's GuidanceModules with the JAX stack's weights."""
    ucfg, vcfg = sdm.tiny_unet_config(), sdm.tiny_vae_config()
    return convert.guidance_modules(
        convert.unet_state_dict(np_tree(jmods.unet_params), ucfg),
        convert.vae_encoder_state_dict(np_tree(jmods.vae_encode_params), vcfg),
        convert.vae_decoder_state_dict(np_tree(jmods.vae_decode_params), vcfg),
        ucfg, vcfg,
        cn_sd=(None if jmods.controlnet_params is None else
               convert.controlnet_state_dict(np_tree(jmods.controlnet_params), ucfg)))


@pytest.fixture(scope="module")
def stacks():
    jg = jax_cn_guidance()
    return jg, port_mods(jg.mods)


def inputs(seed, b=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 8, 8, 4).astype(np.float32),
            np.array([0, 317, 901][:b], np.int32),
            rng.randn(b, 4, 32).astype(np.float32),
            rng.rand(b, 16, 16, 3).astype(np.float32))


def test_controlnet_residuals_match_flax(stacks):
    jg, mods = stacks
    lat, t, ctx, hint = inputs(0)
    jdown, jmid = jg.mods.controlnet_apply(jg.mods.controlnet_params, jnp.asarray(lat),
                                           jnp.asarray(t), jnp.asarray(ctx), jnp.asarray(hint))
    with torch.no_grad():
        down, mid = mods.controlnet(torch.from_numpy(lat).permute(0, 3, 1, 2),
                                    torch.from_numpy(t), torch.from_numpy(ctx),
                                    torch.from_numpy(hint))
    # one residual per UNet skip: conv_in, each resnet, each downsample
    assert len(down) == len(jdown) == 4
    for j, d in zip(jdown, down):
        assert d.dtype == torch.float32
        assert np.abs(np.asarray(j)).max() > 1e-3
        np.testing.assert_allclose(d.permute(0, 2, 3, 1).numpy(), np.asarray(j), atol=ATOL)
    np.testing.assert_allclose(mid.permute(0, 2, 3, 1).numpy(), np.asarray(jmid), atol=ATOL)


def test_unet_control_res_matches_flax(stacks):
    jg, mods = stacks
    lat, t, ctx, hint = inputs(1)
    jres = jg.mods.controlnet_apply(jg.mods.controlnet_params, jnp.asarray(lat), jnp.asarray(t),
                                    jnp.asarray(ctx), jnp.asarray(hint))
    ref = jg.mods.unet_apply(jg.mods.unet_params, jnp.asarray(lat), jnp.asarray(t),
                             jnp.asarray(ctx), control_res=jres)
    plain = jg.mods.unet_apply(jg.mods.unet_params, jnp.asarray(lat), jnp.asarray(t),
                               jnp.asarray(ctx))
    res = ([torch.from_numpy(np.array(r)).permute(0, 3, 1, 2) for r in jres[0]],
           torch.from_numpy(np.array(jres[1])).permute(0, 3, 1, 2))
    with torch.no_grad():
        got = mods.unet(torch.from_numpy(lat).permute(0, 3, 1, 2), torch.from_numpy(t),
                        torch.from_numpy(ctx), control_res=res).permute(0, 2, 3, 1)
        with pytest.raises(AssertionError):
            mods.unet(torch.from_numpy(lat).permute(0, 3, 1, 2), torch.from_numpy(t),
                      torch.from_numpy(ctx), control_res=(res[0][:-1], res[1]))
    assert np.abs(np.asarray(ref) - np.asarray(plain)).max() > 1e-2   # the residuals count
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_ladder_scores_with_hint_match(stacks):
    jg, mods = stacks
    rng = np.random.RandomState(3)
    b = 2
    lat = rng.randn(b, 8, 8, 4).astype(np.float32)
    noise = rng.randn(b, 8, 8, 4).astype(np.float32)
    emb = rng.randn(3 * b, 4, 32).astype(np.float32)
    hint = rng.rand(b, 16, 16, 3).astype(np.float32)
    ts = [180, 390]
    ref = jm.ladder_scores(jg.mods, jnp.asarray(lat), jnp.asarray(noise),
                           jnp.asarray(ts, jnp.int32), jnp.asarray(emb), n_rungs=len(ts),
                           cond_image=jnp.asarray(hint))
    got = tm.ladder_scores(mods, torch.from_numpy(lat), torch.from_numpy(noise), ts,
                           torch.from_numpy(emb), cond_image=torch.from_numpy(hint))
    plain = tm.ladder_scores(mods, torch.from_numpy(lat), torch.from_numpy(noise), ts,
                             torch.from_numpy(emb))
    assert len(got) == len(ref) == len(ts) + 1
    for (jt, jtrip, jlat), (tt, ttrip, tlat), (_, ptrip, _) in zip(ref, got, plain):
        assert int(jt) == tt
        np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), atol=ATOL)
        for a, c in zip(jtrip, ttrip):
            np.testing.assert_allclose(c.numpy(), np.asarray(a), atol=ATOL)
    assert float((got[1][1][0] - plain[1][1][0]).abs().max()) > 1e-2


def test_tiny_controlnet_is_a_no_op():
    """make_tiny_guidance(with_controlnet=True) leaves the zero convs and
    the hint embedding's conv_out at zero in both packages: the ladder with
    a hint equals the ladder without one, bit for bit."""
    tg = tm.make_tiny_guidance(GuidanceParams(), with_controlnet=True, device="cpu")
    jg = jm.make_tiny_guidance(JGuidanceParams(), with_controlnet=True)
    cn = tg.mods.controlnet
    zeros = [cn.controlnet_cond_embedding.conv_out, cn.controlnet_mid_block,
             *cn.controlnet_down_blocks]
    assert len(zeros) == 2 + 4
    assert all(float(m.weight.abs().sum() + m.bias.abs().sum()) == 0 for m in zeros)
    assert float(cn.conv_in.weight.abs().sum()) > 0
    for name, layer in np_tree(jg.mods.controlnet_params)["params"].items():
        if ZERO_INIT.match(name):
            assert all(np.all(v == 0) for v in layer.values()), name
    rng = np.random.RandomState(4)
    lat = torch.from_numpy(rng.randn(2, 8, 8, 4).astype(np.float32))
    noise = torch.from_numpy(rng.randn(2, 8, 8, 4).astype(np.float32))
    emb = torch.from_numpy(rng.randn(6, 4, 32).astype(np.float32))
    hint = torch.from_numpy(rng.rand(2, 16, 16, 3).astype(np.float32))
    with_hint = tm.ladder_scores(tg.mods, lat, noise, [200], emb, cond_image=hint)
    without = tm.ladder_scores(tg.mods, lat, noise, [200], emb)
    for (_, a, la), (_, b, lb) in zip(with_hint, without):
        assert torch.equal(la, lb) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("with_cn", [False, True])
def test_use_controlnet_gate_draws_like_jax(with_cn):
    """False with no draw without a ControlNet or while step <=
    use_control_net_iter; otherwise one draw from the guidance's generator
    against controlnet_ratio, interleaved with ladders and flips as the
    trainers interleave them."""
    jgp, tgp = JGuidanceParams(), GuidanceParams()
    jgp.controlnet_ratio = tgp.controlnet_ratio = 0.4
    jopt, topt = JOptimizationParams(), OptimizationParams()
    jopt.use_control_net_iter = topt.use_control_net_iter = 3
    jg = jm.make_tiny_guidance(jgp, with_controlnet=with_cn)
    tg = tm.make_tiny_guidance(tgp, with_controlnet=with_cn, device="cpu")
    seen = []
    for step in range(1, 12):
        np.testing.assert_array_equal(tg.sample_ladder(0.5), jg.sample_ladder(0.5))
        use = tg.use_controlnet(step, topt)
        assert use == jg.use_controlnet(step, jopt), step
        assert tg.should_flip() == jg.should_flip(), step
        seen.append(use)
    assert not any(seen[:3])
    assert any(seen) == with_cn and (not with_cn or not all(seen[3:]))
