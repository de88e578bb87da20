"""Seeded weights for the guidance modules, made on the device in one draw.

Every convolution and linear kernel is N(0, 1/fan_in) (the variance of
Flax's lecun_normal), every bias zero, every normalization the identity. The
values of a parameter depend only on the seed and the sorted parameter names,
so a module of the program and the same module of the reference
(`reference/sd.py`, diffusers key names in both) get equal tensors by name.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def _kinds(module: nn.Module) -> dict:
    """parameter name -> "kernel" | "zero" | "one"."""
    kinds = {}
    for mname, m in module.named_modules():
        prefix = f"{mname}." if mname else ""
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            kinds[prefix + "weight"] = "kernel"
            if m.bias is not None:
                kinds[prefix + "bias"] = "zero"
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            kinds[prefix + "weight"] = "one"
            kinds[prefix + "bias"] = "zero"
    return kinds


@torch.no_grad()
def fill_(module: nn.Module, seed: int, device, fp8: bool = False) -> nn.Module:
    """Fill every parameter of `module` (already on `device`) from `seed`.
    With `fp8`, each kernel is rounded to float8 e4m3 with a per-tensor
    scale (its absolute maximum over 448), the precision of the control."""
    params = dict(module.named_parameters())
    kinds = _kinds(module)
    missing = sorted(set(params) - set(kinds))
    if missing:
        raise ValueError(f"parameters of no known layer kind: {missing[:5]}")
    kernels = [n for n in sorted(params) if kinds[n] == "kernel"]
    total = sum(params[n].numel() for n in kernels)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn((total,), generator=gen, device=device)
    off = 0
    for n in kernels:
        p = params[n]
        w = flat[off:off + p.numel()].view_as(p) * p[0].numel() ** -0.5
        if fp8:
            scale = w.abs().amax().clamp_min(1e-30) / 448.0
            w = (w / scale).to(torch.float8_e4m3fn).float() * scale
        p.copy_(w)
        off += p.numel()
    del flat
    for n, p in params.items():
        if kinds[n] == "zero":
            p.zero_()
        elif kinds[n] == "one":
            p.fill_(1.0)
    return module
