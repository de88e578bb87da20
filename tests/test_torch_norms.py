"""The SD modules' norms (ops/norms.py) on the CPU: the plain versions are
the modules' float32 composition bit for bit, the path each call takes,
and the state-dict keys the checkpoint loader relies on.

The kernels themselves run only on a card (tests/test_torch_kernels_cuda.py).
"""

import types

import pytest
import torch
import torch.nn.functional as F

from dreamscene_tpu_torch import kernels
from dreamscene_tpu_torch.guidance import sd_modules as sdm
from dreamscene_tpu_torch.ops import norms

torch.set_num_threads(1)

EPS = sdm.NORM_EPS


def _affine(c, gen):
    return (1.0 + 0.3 * torch.randn(c, generator=gen), 0.2 * torch.randn(c, generator=gen))


def _composition(x, groups, w, b, silu, out_dtype, tokens):
    """The modules' ops before the norms took the consumer's dtype and layout:
    the float32 group norm, the holder's F.silu, the permute of an attention
    block, then the consumer's cast."""
    y = F.group_norm(x.float(), groups, w, b, EPS)
    if silu:
        y = F.silu(y)
    if tokens:
        n, c, h, wd = y.shape
        y = y.permute(0, 2, 3, 1).reshape(n, h * wd, c)
    return y.to(out_dtype)


@pytest.mark.parametrize("tokens", [False, True])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [False, True])
def test_group_norm_plain_is_the_float32_composition(in_dtype, out_dtype, silu, tokens,
                                                     channels_last):
    gen = torch.Generator().manual_seed(3)
    x = (3.0 * torch.randn((2, 24, 6, 10), generator=gen) + 1.5).to(in_dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    w, b = _affine(24, gen)
    got = norms.group_norm_plain(x, 4, w, b, EPS, silu, out_dtype, tokens)
    mod = sdm.GroupNorm(4, 24, out_dtype, silu=silu, tokens=tokens)
    with torch.no_grad():
        mod.weight.copy_(w)
        mod.bias.copy_(b)
        via_module = mod(x)
    want = _composition(x, 4, w, b, silu, out_dtype, tokens)
    assert got.dtype == via_module.dtype == out_dtype
    assert got.shape == via_module.shape == ((2, 60, 24) if tokens else (2, 24, 6, 10))
    assert torch.equal(got, want) and torch.equal(via_module, want)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_plain_is_the_float32_composition(in_dtype, out_dtype):
    gen = torch.Generator().manual_seed(4)
    x = (2.0 * torch.randn((2, 7, 40), generator=gen) - 0.5).to(in_dtype)
    w, b = _affine(40, gen)
    want = F.layer_norm(x.float(), (40,), w, b, EPS).to(out_dtype)
    mod = sdm.LayerNorm(40, out_dtype)
    with torch.no_grad():
        mod.weight.copy_(w)
        mod.bias.copy_(b)
        via_module = mod(x)
    assert torch.equal(norms.layer_norm_plain(x, w, b, EPS, out_dtype), want)
    assert torch.equal(via_module, want)


def test_path_follows_device_and_autograd():
    """The device alone decides: autograd recording or not, a CUDA tensor
    takes the kernel (inside its autograd Function), a CPU tensor the plain
    ops."""
    assert norms.path(torch.zeros(1)) == "plain"
    assert norms.path(torch.zeros(1, requires_grad=True)) == "plain"
    cuda = types.SimpleNamespace(device=torch.device("cuda"))
    assert norms.path(cuda) == "kernel"
    with torch.no_grad():
        assert norms.path(cuda) == "kernel"


def _cpu_kernels(monkeypatch, launched):
    """Stand-ins for the kernel wrappers on the CPU: the plain output, out of
    autograd's sight as a kernel's is, and the float32 moments as PyTorch's
    own norms give them."""

    @torch.no_grad()
    def group(x, groups, w, b, eps, silu, out_dtype, tokens):
        launched.append("group")
        n, c, h, wd = x.shape
        _, mean, rstd = torch.ops.aten.native_group_norm(x.float(), w, b, n, c, h * wd, groups,
                                                         eps)
        return norms.group_norm_plain(x, groups, w, b, eps, silu, out_dtype, tokens), mean, rstd

    @torch.no_grad()
    def layer(x, w, b, eps, out_dtype):
        launched.append("layer")
        _, mean, rstd = torch.ops.aten.native_layer_norm(x.float(), w.shape, w, b, eps)
        return norms.layer_norm_plain(x, w, b, eps, out_dtype), mean, rstd

    monkeypatch.setattr(norms, "group_norm_kernel", group)
    monkeypatch.setattr(norms, "layer_norm_kernel", layer)


@pytest.mark.parametrize("which", ["group", "layer"])
def test_dispatch_launches_counts_or_takes_the_plain_ops(which, monkeypatch):
    """The CPU path runs the plain ops and launches nothing; the kernel path
    calls the kernel wrapper once inside the autograd Function, whose
    backward counts the elements it takes in `norm.torch_elems`, and which
    records nothing without autograd."""
    gen = torch.Generator().manual_seed(5)
    w, b = _affine(8, gen)
    x = torch.randn((2, 8, 4, 4) if which == "group" else (2, 5, 8), generator=gen,
                    requires_grad=True)

    def call():
        if which == "group":
            return norms.group_norm(x, 2, w, b, EPS, True, torch.float32, False)
        return norms.layer_norm(x, w, b, EPS, torch.float32)

    want = (norms.group_norm_plain(x, 2, w, b, EPS, True, torch.float32, False)
            if which == "group" else norms.layer_norm_plain(x, w, b, EPS, torch.float32))
    launched = []
    _cpu_kernels(monkeypatch, launched)
    kernels.reset_counts()
    assert torch.equal(call(), want) and not launched
    monkeypatch.setattr(norms, "path", lambda t: "kernel")
    with torch.no_grad():
        assert call().grad_fn is None and launched == [which]
    y = call()
    assert torch.equal(y, want) and launched == [which] * 2
    assert kernels.COUNTS[norms.TORCH_ELEMS] == 0
    y.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert kernels.COUNTS[norms.TORCH_ELEMS] == x.numel()
    assert kernels.COUNTS[norms.KERNEL_ELEMS] == 0        # the stand-ins count nothing


def _grads(fn, *tensors):
    leaves = [t.detach().requires_grad_(True) for t in tensors[:3]]
    y = fn(*leaves)
    gen = torch.Generator().manual_seed(11)
    y.backward(torch.randn(y.shape, generator=gen).to(y.dtype))
    return [t.grad for t in leaves]


def _assert_grads_close(got, want, dtype):
    for g, p in zip(got, want):
        assert g.dtype == p.dtype and g.shape == p.shape
        # bf16: both round float32 values that differ in the last bits
        rtol = 2.0**-7 if g.dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(g, p, rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("tokens", [False, True])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("in_dtype,out_dtype", [(torch.float32, torch.float32),
                                                (torch.bfloat16, torch.bfloat16),
                                                (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("channels_last", [False, True])
def test_group_norm_backward_from_moments_is_autograd_of_plain(in_dtype, out_dtype, silu,
                                                              tokens, channels_last,
                                                              monkeypatch):
    """The kernels' autograd Function (its forward stood in for on the CPU)
    gives x, the weight and the bias the gradients autograd gives the plain
    version, from x and the float32 moments alone."""
    gen = torch.Generator().manual_seed(12)
    x = (3.0 * torch.randn((2, 24, 6, 10), generator=gen) + 1.5).to(in_dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    w, b = _affine(24, gen)
    _cpu_kernels(monkeypatch, [])
    monkeypatch.setattr(norms, "path", lambda t: "kernel")
    got = _grads(lambda xx, ww, bb: norms.group_norm(xx, 4, ww, bb, EPS, silu, out_dtype, tokens),
                 x, w, b)
    want = _grads(lambda xx, ww, bb: norms.group_norm_plain(xx, 4, ww, bb, EPS, silu,
                                                            out_dtype, tokens), x, w, b)
    _assert_grads_close(got, want, in_dtype)


@pytest.mark.parametrize("in_dtype,out_dtype", [(torch.float32, torch.float32),
                                                (torch.bfloat16, torch.bfloat16),
                                                (torch.float32, torch.bfloat16)])
def test_layer_norm_backward_from_moments_is_autograd_of_plain(in_dtype, out_dtype,
                                                              monkeypatch):
    gen = torch.Generator().manual_seed(13)
    x = (2.0 * torch.randn((2, 7, 40), generator=gen) - 0.5).to(in_dtype)
    w, b = _affine(40, gen)
    _cpu_kernels(monkeypatch, [])
    monkeypatch.setattr(norms, "path", lambda t: "kernel")
    got = _grads(lambda xx, ww, bb: norms.layer_norm(xx, ww, bb, EPS, out_dtype), x, w, b)
    want = _grads(lambda xx, ww, bb: norms.layer_norm_plain(xx, ww, bb, EPS, out_dtype), x, w, b)
    _assert_grads_close(got, want, in_dtype)


def test_kernel_wrappers_raise_on_cpu_tensors():
    """A wrapper launches or raises: it never takes the plain version."""
    kernels.reset_counts()
    w, b = torch.ones(8), torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        norms.group_norm_kernel(torch.zeros((1, 8, 2, 2)), 2, w, b, EPS, True,
                                torch.float32, False)
    with pytest.raises(ValueError, match="CUDA"):
        norms.layer_norm_kernel(torch.zeros((3, 8)), w, b, EPS, torch.float32)
    assert all(v == 0 for v in kernels.COUNTS.values())


def test_modules_apply_silu_dtype_and_layout_once():
    """Each holder's norm carries what follows it: SiLU before the resnets'
    convs and the conv_norm_outs, token-major before the attention blocks'
    projections; the compute dtype before a bf16 layer, float32 before the
    float32 conv_out."""
    cfg = sdm.UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                         cross_attention_dim=32, attention_head_dim=16, num_groups=8,
                         with_cross_attn=(True, False))
    with torch.device("meta"):
        unet = sdm.UNet2DCondition(cfg)
        enc = sdm.VAEEncoder(sdm.VAEConfig(block_out_channels=(32, 32), layers_per_block=1,
                                           num_groups=8))
    seen = {(name.rsplit(".", 1)[-1], m.silu, m.out_dtype, m.tokens)
            for top in (unet, enc) for name, m in top.named_modules()
            if isinstance(m, sdm.GroupNorm)}
    assert seen == {("norm1", True, torch.bfloat16, False),
                    ("norm2", True, torch.bfloat16, False),
                    ("norm", False, torch.bfloat16, True),
                    ("group_norm", False, torch.bfloat16, True),
                    ("conv_norm_out", True, torch.float32, False)}


def _keys(module):
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


@pytest.mark.parametrize("part", ["unet", "controlnet", "vae_encoder", "vae_decoder"])
def test_state_dict_keys_are_the_published_ones(part):
    """The modules hold the diffusers keys and shapes at SD 2.1's widths (the
    loader loads with strict=True): the norms' new settings are attributes,
    not parameters or buffers. Held against the benchmark's independent
    reference modules."""
    from benchmark.reference import sd as ref

    ucfg, vcfg = sdm.sd21_unet_config(), sdm.VAEConfig()
    rucfg, rvcfg = ref.sd21_unet_config(), ref.VAEConfig()
    build = {"unet": lambda m, u, v: m.UNet2DCondition(u),
             "controlnet": lambda m, u, v: m.ControlNet(u),
             "vae_encoder": lambda m, u, v: m.VAEEncoder(v),
             "vae_decoder": lambda m, u, v: m.VAEDecoder(v)}[part]
    with torch.device("meta"):
        got = _keys(build(sdm, ucfg, vcfg))
        want = _keys(build(ref, rucfg, rvcfg))
    assert got == want
    assert any(k.endswith("norm1.weight") for k in got)
