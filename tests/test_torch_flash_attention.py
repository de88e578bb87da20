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
Flax modules at atol 1e-5 on outputs and input gradients; `Attention`
hands the kernels strided [b, h, n, d] views of its projections.

The choice of kernel variant and tiling (`kernel_variant`, `fwd_config`,
`dkv_config`) is pure Python and is pinned here for every shape of the
main path: shared memory within one CTA's 232,448 bytes, tiles dividing
n.
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

# One intra-op thread: the suite runs several worker processes at once, and
# one OpenMP team of all cores per worker makes these small tensors wait on
# each other (the six heaviest files of the port took 205 s on 8 cores with
# 6 workers, 66 s with one thread each).
torch.set_num_threads(1)


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


# Three heads, not the two of tests/test_flash_attention.py::
# test_gradient_parity: after a jax.vjp of the interpreted kernel at exactly
# that test's shape and type, its jax.grad in the same process never
# returns, and which files share a worker process is the scheduler's choice.
@pytest.mark.parametrize("shape,dtype", [((1, 3, 1024, 64), "float32"),
                                         ((1, 1, 256, 512), "float32"),
                                         ((1, 3, 1024, 64), "bfloat16")])
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


# (head dim, dtype) -> variant, forward design. The first two rows are the
# main path's UNet and VAE shapes ([12,5,4096,64], [12,10,1024,64],
# [4,1,4096,512], [1,1,4096,512], all bfloat16).
@pytest.mark.parametrize("d,dtype,variant,design", [
    (64, torch.bfloat16, "tc", "tc_wgmma"),
    (512, torch.bfloat16, "tc", "tc_split"),
    (128, torch.bfloat16, "tc", "tc_split"),
    (256, torch.bfloat16, "tc", "tc_split"),
    (48, torch.bfloat16, "tc", "tc_wgmma"),
    (384, torch.bfloat16, "tc", "tc_split"),
    (40, torch.bfloat16, "scalar", "scalar"),     # d % 16 != 0
    (64, torch.float32, "scalar", "scalar"),      # no f32 product on tensor cores
    (512, torch.float32, "scalar", "scalar"),
])
def test_kernel_variant_and_tiles(d, dtype, variant, design):
    assert fa.kernel_variant(dtype, d) == variant
    fwd, dkv, dq = fa.fwd_config(dtype, d), fa.dkv_config(dtype, d), fa.dq_config(dtype, d)
    assert fwd["variant"] == dkv["variant"] == dq["variant"] == variant
    assert fwd["design"] == design
    for cfg in (fwd, dkv, dq):
        assert cfg["bucket"] == fa.head_bucket(d) >= d
        assert cfg["smem"] <= fa.SMEM_LIMIT == 232_448, cfg
        assert 128 % cfg["bq"] == 0 and 128 % cfg["bk"] == 0, cfg   # n % 128 == 0
        assert cfg["threads"] % 32 == 0 and cfg["threads"] <= 1024
    if variant == "tc":
        assert fwd["bq"] % 16 == 0 and fwd["bk"] % 16 == 0
        assert dkv["bucket"] % (dkv["threads"] // 32 * 16) == 0   # columns per warp
        assert dq["bucket"] % (dq["threads"] // 32 * 16) == 0
        assert dq["bq"] % 16 == 0 and dq["bk"] % 16 == 0


# the dQ kernel's tiles per bucket (csrc/flash_bwd_dq.cu TcCfg / Cfg), for
# both types and for head dims that are padded up to their bucket
@pytest.mark.parametrize("d,dtype,variant,threads,bq,bk,smem", [
    (64, torch.bfloat16, "tc", 128, 64, 64, 58_368),
    (48, torch.bfloat16, "tc", 128, 64, 64, 58_368),
    (16, torch.bfloat16, "tc", 128, 64, 64, 58_368),
    (128, torch.bfloat16, "tc", 256, 64, 64, 107_520),
    (96, torch.bfloat16, "tc", 256, 64, 64, 107_520),
    (256, torch.bfloat16, "tc", 256, 64, 32, 136_192),
    (512, torch.bfloat16, "tc", 256, 64, 16, 199_680),
    (384, torch.bfloat16, "tc", 256, 64, 16, 199_680),
    (64, torch.float32, "scalar", 128, 64, 64, 83_968),
    (128, torch.float32, "scalar", 128, 32, 32, 70_656),
    (256, torch.float32, "scalar", 256, 32, 32, 136_192),
    (512, torch.float32, "scalar", 256, 16, 16, 132_608),
    (384, torch.float32, "scalar", 256, 16, 16, 132_608),
    (40, torch.bfloat16, "scalar", 128, 64, 64, 83_968),
    (72, torch.bfloat16, "scalar", 128, 32, 32, 70_656),
])
def test_dq_config_tiles(d, dtype, variant, threads, bq, bk, smem):
    cfg = fa.dq_config(dtype, d)
    assert (cfg["variant"], cfg["threads"], cfg["bq"], cfg["bk"], cfg["smem"]) == (
        variant, threads, bq, bk, smem)
    assert cfg["smem"] <= fa.SMEM_LIMIT
    assert cfg["design"] == variant
    if variant == "tc":
        # Q + dO resident, two stages of K and V, the padded ds tile
        D = fa.head_bucket(d)
        assert smem == (2 * bq + 4 * bk) * D * 2 + bq * (bk + 8) * 2


def test_head_bucket():
    assert [fa.head_bucket(d) for d in (1, 64, 65, 128, 256, 257, 512)] == [
        64, 64, 128, 128, 256, 512, 512]


def test_strided_views_match_contiguous():
    """q, k, v as transposed views of [b, n, h*d] projections give the
    same values and gradients as contiguous copies."""
    b, h, n, d = 2, 2, 256, 16
    rng = np.random.default_rng(5)
    proj = [torch.tensor(rng.standard_normal((b, n, h * d)).astype(np.float32),
                         requires_grad=True) for _ in range(3)]
    views = [x.reshape(b, n, h, d).transpose(1, 2) for x in proj]
    assert not any(x.is_contiguous() for x in views)
    assert list(fa._strides(views[0])) == [n * h * d, d, h * d]
    assert list(fa._strides(views[0][:, :1])) == [n * h * d, 0, h * d]   # size-1 head dim
    assert list(fa._strides(views[0][:1])) == [0, d, h * d]
    g = torch.tensor(rng.standard_normal((b, h, n, d)).astype(np.float32))
    o = fa.flash_attention(*views, d**-0.5)
    o.backward(g)
    grads = [x.grad.clone() for x in proj]
    dense = [x.detach().contiguous().requires_grad_(True) for x in views]
    o2 = fa.flash_attention(*dense, d**-0.5)
    o2.backward(g)
    assert torch.equal(o, o2)
    for a, x in zip(grads, dense):
        assert torch.equal(a.reshape(b, n, h, d).transpose(1, 2), x.grad)


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
    # the module hands K4 strided [b, h, n, d] views of its [b, n, h*d]
    # projections, without a copy
    seen, flash_attention = [], fa.flash_attention

    def record(q, k, v, scale):
        seen.append([(tuple(t.shape), t.stride(), t.is_contiguous()) for t in (q, k, v)])
        return flash_attention(q, k, v, scale)

    monkeypatch.setattr(fa, "flash_attention", record)
    tx = torch.tensor(x, requires_grad=True)
    to = tmod(tx)
    to.backward(torch.tensor(g))
    assert len(seen) == 1
    for shape, stride, contiguous in seen[0]:
        assert shape == (b, heads, n, hd) and not contiguous
        assert stride == (n * heads * hd, hd, heads * hd, 1)
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
