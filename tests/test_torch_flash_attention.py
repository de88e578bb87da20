"""K4, flash attention: the port's ops/flash_attention.py (plain versions
on the CPU) against the JAX package's `sd_flax._flash_attention` (the
Pallas TPU kernel, forced into interpret mode as
tests/test_flash_attention.py runs it), on the same seeded numpy inputs.

Tolerances: float32 forward atol 2e-6 and gradients atol 5e-6 (the JAX
suite's own, tests/test_flash_attention.py:53,73); bfloat16 forward and
gradients within one bf16 ulp of the JAX output at the tensor's scale
(the ulp of its largest magnitude), and at most 0.1% of the elements more
than one ulp of their own magnitude away: near-zero results of long f32
sums differ in their last bits with the summation order. The
modules (`Attention`, `VAEAttention`) with the flash route forced on both
sides (the JAX gate monkeypatched to True in the test only) match the
Flax modules at atol 1e-5 on outputs and input gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dreamscene_tpu.guidance import sd_flax
from dreamscene_tpu_torch.guidance import sd_modules as sdm
from dreamscene_tpu_torch.ops import flash_attention as fa


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _jax_flash(q, k, v, g, scale, jdt):
    with pltpu.force_tpu_interpret_mode():
        args = [jnp.asarray(x, jdt) for x in (q, k, v)]
        o, vjp = jax.vjp(lambda a, b, c: sd_flax._flash_attention(a, b, c, scale), *args)
        grads = vjp(jnp.asarray(g, jdt))
    return [np.asarray(x.astype(jnp.float32)) for x in (o, *grads)]


def _port_flash(q, k, v, g, scale, dt):
    t = [torch.tensor(x).to(dt).requires_grad_(True) for x in (q, k, v)]
    o = fa.flash_attention(*t, scale)
    o.backward(torch.tensor(g).to(dt))
    return [x.detach().float().numpy() for x in (o, t[0].grad, t[1].grad, t[2].grad)]


def _bf16_ulp(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("shape,dtype", [((1, 2, 1024, 64), "float32"),
                                         ((1, 1, 256, 512), "float32"),
                                         ((1, 2, 1024, 64), "bfloat16")])
def test_flash_attention_matches_jax_kernel(shape, dtype):
    q, k, v, g = _inputs(shape, seed=shape[-1])
    scale = shape[-1] ** -0.5
    want = _jax_flash(q, k, v, g, scale, jnp.dtype(dtype))
    got = _port_flash(q, k, v, g, scale, getattr(torch, dtype))
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        if dtype == "float32":
            np.testing.assert_allclose(a, b, atol=2e-6 if name == "o" else 5e-6, err_msg=name)
        else:
            err = np.abs(a - b)
            assert err.max() <= _bf16_ulp(np.abs(b).max()), (name, float(err.max()))
            assert (err > _bf16_ulp(b)).mean() <= 1e-3, (name, int((err > _bf16_ulp(b)).sum()))


def test_gate(monkeypatch):
    monkeypatch.delenv("DS_FLASH_ATTN", raising=False)
    assert not fa.use_flash_attention(4096, 4096, "cuda")
    monkeypatch.setenv("DS_FLASH_ATTN", "0")
    assert not fa.use_flash_attention(4096, 4096, "cuda")
    monkeypatch.setenv("DS_FLASH_ATTN", "1")
    assert fa.use_flash_attention(4096, 4096, "cuda")
    assert fa.use_flash_attention(1024, 1024, torch.device("cuda", 0))
    assert not fa.use_flash_attention(4096, 77, "cuda")      # cross-attention
    assert not fa.use_flash_attention(896, 896, "cuda")      # n < 1024
    assert not fa.use_flash_attention(1100, 1100, "cuda")    # n % 128 != 0
    assert not fa.use_flash_attention(4096, 4096, "cpu")     # only on the card


@pytest.mark.parametrize("shape,dtype", [((1, 1, 200, 64), torch.float32),
                                         ((1, 1, 256, 192), torch.float32),
                                         ((1, 1, 256, 640), torch.float32),
                                         ((1, 1, 256, 64), torch.float16)])
def test_limits_raise(shape, dtype):
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError):
        fa.flash_attention(x, x, x, 1.0)


def _force_flash(monkeypatch):
    monkeypatch.setattr(sd_flax, "_use_flash_attention", lambda n, m: True)
    monkeypatch.setattr(fa, "use_flash_attention", lambda n, m, device: True)


def _dense(sd, key, p, bias=True):
    sd[key + ".weight"] = torch.tensor(np.asarray(p["kernel"]).T)
    if bias:
        sd[key + ".bias"] = torch.tensor(np.asarray(p["bias"]))


def test_attention_module_flash_route_matches_flax(monkeypatch):
    _force_flash(monkeypatch)
    b, n, dim, heads, hd = 2, 256, 32, 2, 16
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, n, dim)).astype(np.float32)
    g = rng.standard_normal((b, n, dim)).astype(np.float32)
    mod = sd_flax.Attention(dim, heads, hd, jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        params = mod.init(jax.random.key(0), jnp.asarray(x))
        jo, vjp = jax.vjp(lambda a: mod.apply(params, a), jnp.asarray(x))
        (jdx,) = vjp(jnp.asarray(g))
    p = params["params"]
    sd = {}
    for name in ("to_q", "to_k", "to_v"):
        _dense(sd, name, p[name], bias=False)
    _dense(sd, "to_out.0", p["to_out_0"])
    tmod = sdm.Attention(dim, heads, hd, torch.float32)
    tmod.load_state_dict(sd)
    tx = torch.tensor(x, requires_grad=True)
    to = tmod(tx)
    to.backward(torch.tensor(g))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=1e-5)


def test_vae_attention_module_flash_route_matches_flax(monkeypatch):
    _force_flash(monkeypatch)
    b, h, w, c = 2, 16, 16, 32
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    mod = sd_flax.VAEAttention(c, 8, jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        params = mod.init(jax.random.key(1), jnp.asarray(x))
        jo, vjp = jax.vjp(lambda a: mod.apply(params, a), jnp.asarray(x))
        (jdx,) = vjp(jnp.asarray(g))
    p = params["params"]
    sd = {"group_norm.weight": torch.tensor(np.asarray(p["group_norm"]["scale"])),
          "group_norm.bias": torch.tensor(np.asarray(p["group_norm"]["bias"]))}
    for name in ("to_q", "to_k", "to_v"):
        _dense(sd, name, p[name])
    _dense(sd, "to_out.0", p["to_out_0"])
    tmod = sdm.VAEAttention(c, 8, torch.float32)
    tmod.load_state_dict(sd)
    tx = torch.tensor(x.transpose(0, 3, 1, 2).copy(), requires_grad=True)
    to = tmod(tx)
    to.backward(torch.tensor(g.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(to.detach().numpy().transpose(0, 2, 3, 1), np.asarray(jo),
                               atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy().transpose(0, 2, 3, 1), np.asarray(jdx),
                               atol=1e-5)
