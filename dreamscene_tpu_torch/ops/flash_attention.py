"""Flash attention (kernel K4): forward and both backward kernels.

Port of the Pallas TPU flash attention that the JAX package calls from
dreamscene_tpu/guidance/sd_flax.py:120 (`_flash_attention`, the library
kernel jax.experimental.pallas.ops.tpu.flash_attention: the forward
pallas_call and its VJP's `_flash_attention_bwd_dkv` and
`_flash_attention_bwd_dq`).

`flash_attention(q, k, v, scale)` on [b, h, n, d] is an autograd Function
with the JAX kernels' numeric contract:
  * forward: s = q.k^T in float32, then s *= scale (after the product,
    not on q first as the matmul path does); online softmax with running
    m and l; p = exp(s - m_next) in float32, cast to the operand type
    before P.V, float32 accumulation; acc = acc * (l_corr / l_next) +
    (P.V) / l_next with the l_next == 0 guard; output in the operand type.
  * backward: di = sum(o * do) over d from the stored (operand-type)
    output; dK/dV from the recomputed p = exp(s - m) * (1 / l), with p^T
    and ds^T cast to do's type; dQ from ds cast to k's type; ds *= scale
    in both.
Limits (the JAX kernel's, raised on): n a multiple of 128; head dim at
most 128, or a multiple of 128. The port's own upper bound on d is
MAX_HEAD_DIM = 512 (the kernels stage float32 tiles of width 512 in
shared memory).

CUDA tensors launch the hand-written kernels (csrc/flash_fwd.cu,
flash_bwd_dkv.cu, flash_bwd_dq.cu), which tile differently from the TPU
kernel; CPU tensors run the plain versions, which follow the JAX blocking
exactly: bq = bk = the first of 512/256/128 dividing n
(sd_flax.py:130), one step without the running rescale when that block
is all of n.

`use_flash_attention(n, m, device)` is the gate of sd_flax.py:102-117:
DS_FLASH_ATTN == "1" (read at call time), n == m, n >= 1024, n % 128 == 0,
and a CUDA device where the JAX package asks for a TPU.
"""

from __future__ import annotations

import os

import torch

from dreamscene_tpu_torch import kernels

MAX_HEAD_DIM = 512
_DTYPES = (torch.float32, torch.bfloat16)


def use_flash_attention(n: int, m: int, device) -> bool:
    if os.environ.get("DS_FLASH_ATTN") != "1":
        return False
    return (n == m and n >= 1024 and n % 128 == 0
            and torch.device(device).type == "cuda")


def block_size(n: int) -> int:
    """The JAX package's block choice: first of 512/256/128 dividing n."""
    return next(b for b in (512, 256, 128) if n % b == 0)


def check_shapes(q, k, v):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention: q, k, v must share one [b, h, n, d] shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: operands must all be float32 or bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    n, d = q.shape[2], q.shape[3]
    if n % 128:
        raise ValueError(f"flash_attention: n={n} must be a multiple of 128")
    if d > 128 and d % 128:
        raise ValueError(f"flash_attention: head_dim={d} must be <= 128 or a multiple of 128")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim={d} exceeds {MAX_HEAD_DIM}")


def _dot(a, b):
    """[.., n, k] x [.., m, k] -> [.., n, m], float32 accumulation."""
    return torch.matmul(a.float(), b.float().transpose(-1, -2))


def flash_attention_fwd_plain(q, k, v, scale: float):
    """Plain version of the forward kernel, JAX blocking. Returns
    (o [b,h,n,d] in the operand type, l [b,h,n], m [b,h,n] float32)."""
    n = q.shape[2]
    blk = block_size(n)
    dt = q.dtype
    if blk == n:   # the JAX kernel's single-step variant
        s = _dot(q, k) * scale
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        p = p / l
        o = torch.matmul(p.to(dt).float(), v.float()).to(dt)
        return o, l[..., 0], m[..., 0]
    m_prev = q.new_full(q.shape[:3] + (1,), float("-inf"), dtype=torch.float32)
    l_prev = torch.zeros_like(m_prev)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, n, blk):
        s = _dot(q, k[:, :, k0:k0 + blk]) * scale
        m_next = torch.maximum(m_prev, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_next)
        l_corr = torch.exp(m_prev - m_next) * l_prev
        l_next = p.sum(-1, keepdim=True) + l_corr
        inv = torch.where(l_next == 0.0, torch.ones_like(l_next), 1.0 / l_next)
        acc = acc * (l_corr * inv)
        acc = acc + torch.matmul(p.to(dt).float(), v[:, :, k0:k0 + blk].float()) * inv
        m_prev, l_prev = m_next, l_next
    return acc.to(dt), l_prev[..., 0], m_prev[..., 0]


def flash_attention_bwd_plain(q, k, v, l, m, do, di, scale: float):
    """Plain version of both backward kernels, JAX blocking: for each key
    block (outer) and query block (inner), in the JAX kernels' orders.
    Returns (dq, dk, dv) in the operand type."""
    n = q.shape[2]
    blk = block_size(n)
    inv_l = (1.0 / l)[..., None]
    m = m[..., None]
    di = di[..., None]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    for k0 in range(0, n, blk):
        ks, vs = k[:, :, k0:k0 + blk], v[:, :, k0:k0 + blk]
        for q0 in range(0, n, blk):
            qs, dos = q[:, :, q0:q0 + blk], do[:, :, q0:q0 + blk]
            s = _dot(qs, ks) * scale
            p = torch.exp(s - m[:, :, q0:q0 + blk]) * inv_l[:, :, q0:q0 + blk]
            dp = _dot(dos, vs)
            ds = (dp - di[:, :, q0:q0 + blk]) * p * scale
            dv[:, :, k0:k0 + blk] += torch.matmul(
                p.transpose(-1, -2).to(do.dtype).float(), dos.float())
            dk[:, :, k0:k0 + blk] += torch.matmul(
                ds.transpose(-1, -2).to(do.dtype).float(), qs.float())
            dq[:, :, q0:q0 + blk] += torch.matmul(ds.to(k.dtype).float(), ks.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def launch_fwd(q, k, v, o, l, m, scale: float) -> None:
    """The forward kernel alone, into preallocated o, l, m."""
    b, h, n, d = q.shape
    code = kernels.lib().ds_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), l.data_ptr(), m.data_ptr(),
        b * h, n, d, float(scale), int(q.dtype == torch.bfloat16),
        kernels.stream_ptr(q.device))
    kernels.check(code, "flash_fwd")
    kernels.COUNTS["flash_fwd"] += 1


def launch_bwd_dkv(q, k, v, l, m, do, di, dk, dv, scale: float) -> None:
    """The dK/dV kernel alone, into preallocated dk, dv."""
    b, h, n, d = q.shape
    code = kernels.lib().ds_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), l.data_ptr(), m.data_ptr(), do.data_ptr(),
        di.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, n, d, float(scale),
        int(q.dtype == torch.bfloat16), kernels.stream_ptr(q.device))
    kernels.check(code, "flash_bwd_dkv")
    kernels.COUNTS["flash_bwd_dkv"] += 1


def launch_bwd_dq(q, k, v, l, m, do, di, dq, scale: float) -> None:
    """The dQ kernel alone, into a preallocated dq."""
    b, h, n, d = q.shape
    code = kernels.lib().ds_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), l.data_ptr(), m.data_ptr(), do.data_ptr(),
        di.data_ptr(), dq.data_ptr(), b * h, n, d, float(scale),
        int(q.dtype == torch.bfloat16), kernels.stream_ptr(q.device))
    kernels.check(code, "flash_bwd_dq")
    kernels.COUNTS["flash_bwd_dq"] += 1


def flash_fwd(q, k, v, scale: float):
    """Forward kernel on CUDA tensors, plain version on CPU tensors.
    Returns (o, l, m)."""
    check_shapes(q, k, v)
    if q.device.type != "cuda":
        return flash_attention_fwd_plain(q, k, v, scale)
    for name, t in (("q", q), ("k", k), ("v", v)):
        kernels.require(t, name, q.dtype)
    o = torch.empty_like(q)
    l = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    launch_fwd(q, k, v, o, l, m, scale)
    return o, l, m


def flash_bwd(q, k, v, o, l, m, do, scale: float):
    """Both backward kernels on CUDA tensors (dK/dV, then dQ), the plain
    version on CPU tensors. di comes from the stored output. Returns
    (dq, dk, dv)."""
    di = (o.float() * do.float()).sum(-1)
    if q.device.type != "cuda":
        return flash_attention_bwd_plain(q, k, v, l, m, do, di, scale)
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        kernels.require(t, name, q.dtype, q.shape)
    for name, t in (("l", l), ("m", m), ("di", di)):
        kernels.require(t, name, torch.float32, q.shape[:3])
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    launch_bwd_dkv(q, k, v, l, m, do, di, dk, dv, scale)
    launch_bwd_dq(q, k, v, l, m, do, di, dq, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, l, m = flash_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, l, m)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, l, m = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, l, m, do.contiguous(), ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: float):
    """softmax(scale * q k^T) v on [b, h, n, d] through K4."""
    return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), float(scale))
