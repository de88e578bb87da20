"""Group norm (optionally followed by SiLU) and layer norm of the SD modules.

Replaces no Pallas kernel: the JAX package leaves Flax's nn.GroupNorm and
nn.LayerNorm (dreamscene_tpu/guidance/sd_flax.py:89-95, 195-201, 218, 310)
to XLA, which fuses the float32 cast, the moments, the normalisation and
the SiLU after it. Eager PyTorch on the card fuses none of it, so the card
takes the hand-written kernels of csrc/norm.cu: they read the activation
once, keep float32 moments, and write the dtype (and for an attention
block's input, the token-major layout) that the consumer reads.

`group_norm(x, groups, weight, bias, eps, silu, out_dtype, tokens)`: x
[b, c, h, w] (NCHW or channels-last), weight and bias float32 [c];
normalised in float32, then SiLU when `silu`, rounded once to `out_dtype`,
returned as [b, c, h, w], or as [b, h*w, c] when `tokens`.
`layer_norm(x, weight, bias, eps, out_dtype)` normalises the last dim.

What a call observes decides the path; there is no knob:
  * a CPU tensor: the plain version, the modules' float32 ops
    (`F.group_norm(x.float())`, `F.silu`, `.to(out_dtype)`) bit for bit;
  * a CUDA tensor: the kernel (`group_norm_fwd`, `layer_norm_fwd` in
    `kernels.COUNTS`), inside an autograd Function. The kernel also writes
    the float32 mean and rstd of each slab or row; where autograd records
    (the VAE encoder inside the FPS step, whose input is the rendered
    images), the backward computes the gradients from them and x with
    PyTorch's ops (the SiLU's input recomputed in float32, then
    `native_group_norm_backward` / `native_layer_norm_backward`), as
    autograd differentiates the plain version. The kernel wrappers launch
    or raise; they never take the plain version.
Each launch adds the elements it reads to `kernels.COUNTS["norm.kernel_elems"]`
and each backward its elements to `"norm.torch_elems"`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dreamscene_tpu_torch import kernels

KERNEL_ELEMS, TORCH_ELEMS = "norm.kernel_elems", "norm.torch_elems"
_DTYPES = (torch.float32, torch.bfloat16)


def group_norm_plain(x, groups: int, weight, bias, eps: float, silu: bool,
                     out_dtype: torch.dtype, tokens: bool):
    y = F.group_norm(x.float(), groups, weight, bias, eps)
    if silu:
        y = F.silu(y)
    y = y.to(out_dtype)
    if tokens:
        b, c, h, w = y.shape
        y = y.permute(0, 2, 3, 1).reshape(b, h * w, c)
    return y


def layer_norm_plain(x, weight, bias, eps: float, out_dtype: torch.dtype):
    return F.layer_norm(x.float(), weight.shape, weight, bias, eps).to(out_dtype)


def _require_affine(weight, bias, c: int) -> None:
    kernels.require(weight, "weight", torch.float32, (c,))
    kernels.require(bias, "bias", torch.float32, (c,))


def _require_dtypes(x, out_dtype) -> None:
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"norm kernels take float32 or bfloat16, got {x.dtype} -> {out_dtype}")


def group_norm_kernel(x, groups: int, weight, bias, eps: float, silu: bool,
                      out_dtype: torch.dtype, tokens: bool):
    """The group-norm kernel on a CUDA [b, c, h, w] tensor laid out NCHW or
    channels-last; raises on anything else. Returns (y, mean, rstd), the
    latter the float32 [b, groups] moments a backward needs."""
    if x.device.type != "cuda" or x.dim() != 4:
        raise ValueError(f"group_norm_kernel: expected a CUDA [b, c, h, w] tensor, got "
                         f"{x.device} {tuple(x.shape)}")
    _require_dtypes(x, out_dtype)
    b, c, h, w = x.shape
    if c % groups:
        raise ValueError(f"group_norm_kernel: {c} channels in {groups} groups")
    _require_affine(weight, bias, c)
    in_cl = not x.is_contiguous()
    if in_cl and not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"group_norm_kernel: expected NCHW or channels-last, got strides "
                         f"{x.stride()}")
    y = torch.empty((b, h * w, c) if tokens else (b, c, h, w), dtype=out_dtype, device=x.device)
    mean, rstd = _moments((b, groups), x.device)
    code = kernels.lib().ds_group_norm_fwd(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), b, c, h * w, groups, float(eps), int(silu), int(in_cl), int(tokens),
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        kernels.stream_ptr(x.device))
    kernels.check(code, "group_norm_fwd")
    kernels.COUNTS["group_norm_fwd"] += 1
    kernels.COUNTS[KERNEL_ELEMS] += x.numel()
    return y, mean, rstd


def layer_norm_kernel(x, weight, bias, eps: float, out_dtype: torch.dtype):
    """The layer-norm kernel over the last dim of a contiguous CUDA tensor;
    raises on anything else. Returns (y, mean, rstd), the latter float32
    [..., 1] as `native_layer_norm` gives them."""
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError(f"layer_norm_kernel: expected a contiguous CUDA tensor, got "
                         f"{x.device} strides {x.stride()}")
    _require_dtypes(x, out_dtype)
    c = x.shape[-1]
    _require_affine(weight, bias, c)
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    mean, rstd = _moments((*x.shape[:-1], 1), x.device)
    code = kernels.lib().ds_layer_norm_fwd(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), x.numel() // c, c, float(eps), int(x.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), kernels.stream_ptr(x.device))
    kernels.check(code, "layer_norm_fwd")
    kernels.COUNTS["layer_norm_fwd"] += 1
    kernels.COUNTS[KERNEL_ELEMS] += x.numel()
    return y, mean, rstd


def _moments(shape, device):
    return tuple(torch.empty(shape, dtype=torch.float32, device=device) for _ in range(2))


def group_norm_backward(dy, x, weight, bias, mean, rstd, groups: int, silu: bool, tokens: bool,
                        needs=(True, True, True)):
    """(dx, dweight, dbias) of the group norm (and SiLU) from its input and
    its float32 moments [b, groups], as autograd computes them for the plain
    version; None where `needs` says no."""
    b, c, h, w = x.shape
    if tokens:
        dy = dy.reshape(b, h, w, c).permute(0, 3, 1, 2)
    dy = dy.float().contiguous()
    if silu:   # the SiLU's input, x * a + b as the kernel forms it, in one pass over x
        a = rstd.repeat_interleave(c // groups, 1).view(b, c, 1, 1) * weight.view(1, c, 1, 1)
        shift = bias.view(1, c, 1, 1) - mean.repeat_interleave(c // groups, 1).view(b, c, 1, 1) * a
        dy = torch.ops.aten.silu_backward(dy, torch.addcmul(shift, x, a)).contiguous()
    dx, dw, db = torch.ops.aten.native_group_norm_backward(
        dy, x.float().contiguous(), mean, rstd, weight, b, c, h * w, groups, list(needs))
    return (None if dx is None else dx.to(x.dtype)), dw, db


def layer_norm_backward(dy, x, weight, bias, mean, rstd, needs=(True, True, True)):
    """(dx, dweight, dbias) of the layer norm from its input and its float32
    moments [..., 1]; None where `needs` says no."""
    dx, dw, db = torch.ops.aten.native_layer_norm_backward(
        dy.float().contiguous(), x.float().contiguous(), weight.shape, mean, rstd, weight, bias,
        list(needs))
    return (None if dx is None else dx.to(x.dtype)), dw, db


class _GroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, silu, out_dtype, tokens):
        y, mean, rstd = group_norm_kernel(x, groups, weight, bias, eps, silu, out_dtype, tokens)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        ctx.args = (groups, silu, tokens)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        kernels.COUNTS[TORCH_ELEMS] += x.numel()
        grads = group_norm_backward(dy, x, weight, bias, mean, rstd, *ctx.args,
                                    needs=ctx.needs_input_grad[:3])
        return (*grads, None, None, None, None, None)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps, out_dtype):
        y, mean, rstd = layer_norm_kernel(x, weight, bias, eps, out_dtype)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        kernels.COUNTS[TORCH_ELEMS] += x.numel()
        grads = layer_norm_backward(dy, x, weight, bias, mean, rstd,
                                    needs=ctx.needs_input_grad[:3])
        return (*grads, None, None)


def path(x) -> str:
    """"plain" (a CPU tensor) or "kernel" (a CUDA tensor)."""
    return "kernel" if x.device.type == "cuda" else "plain"


def group_norm(x, groups: int, weight, bias, eps: float, silu: bool, out_dtype: torch.dtype,
               tokens: bool):
    if path(x) == "kernel":
        return _GroupNorm.apply(x, weight, bias, groups, eps, silu, out_dtype, tokens)
    return group_norm_plain(x, groups, weight, bias, eps, silu, out_dtype, tokens)


def layer_norm(x, weight, bias, eps: float, out_dtype: torch.dtype):
    if path(x) == "kernel":
        return _LayerNorm.apply(x, weight, bias, eps, out_dtype)
    return layer_norm_plain(x, weight, bias, eps, out_dtype)
