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
MAX_HEAD_DIM = 512 (the kernels' widest head-dim bucket).

CUDA tensors launch the hand-written kernels (csrc/flash_fwd.cu,
flash_bwd_dkv.cu, flash_bwd_dq.cu), which tile differently from the TPU
kernel; CPU tensors run the plain versions, which follow the JAX blocking
exactly: bq = bk = the first of 512/256/128 dividing n
(sd_flax.py:130), one step without the running rescale when that block
is all of n.

Which kernel variant a CUDA tensor takes is decided here, by type and
shape alone (`kernel_variant`, `fwd_config`, `dkv_config`, `dq_config`):
bfloat16 operands with a head dim that is a multiple of 16 take the
tensor-core kernels (wgmma or mma.sync on bfloat16 tiles; "tc"); float32
operands, for which tensor cores have no product at float32 accuracy, and
other bfloat16 head dims take the CUDA-core kernels ("scalar"). All three
kernels have both variants. Nothing is caught: a launch that fails raises.

The forward takes q, k, v as any [b, h, n, d] views with unit stride in d
(the modules pass transposed views of their [b, n, h*d] projections) and
returns o laid out as [b, n, h, d], so `o.transpose(1, 2).reshape(b, n,
h*d)` is a view too. The backward kernels want contiguous heads; the
autograd Function copies only the tensors that are not (none at h = 1).

`use_flash_attention(n, m, device)` is the gate of sd_flax.py:102-117:
DS_FLASH_ATTN == "1" (read at call time), n == m, n >= 1024, n % 128 == 0,
and a CUDA device where the JAX package asks for a TPU.
"""

from __future__ import annotations

import ctypes
import os

import torch

from dreamscene_tpu_torch import kernels

MAX_HEAD_DIM = 512
SMEM_LIMIT = 232_448   # dynamic shared memory one CTA can have on an H100
_DTYPES = (torch.float32, torch.bfloat16)
_BUCKETS = (64, 128, 256, 512)
# scalar kernels' tiles per head-dim bucket: (threads, bq, bk), csrc Cfg<D>
_SCALAR_FWD = {64: (128, 64, 64), 128: (128, 32, 64), 256: (256, 32, 32), 512: (256, 16, 32)}
_SCALAR_DKV = {64: (128, 64, 64), 128: (128, 32, 32), 256: (256, 32, 32), 512: (256, 16, 16)}
# tensor-core dK/dV tiles per bucket: (threads, bq, bk), csrc TcCfg<D>
_TC_DKV = {64: (128, 64, 64), 128: (256, 64, 64), 256: (256, 32, 64), 512: (256, 32, 32)}
# dQ, csrc/flash_bwd_dq.cu: Cfg<D> and TcCfg<D>
_SCALAR_DQ = {64: (128, 64, 64), 128: (128, 32, 32), 256: (256, 32, 32), 512: (256, 16, 16)}
_TC_DQ = {64: (128, 64, 64), 128: (256, 64, 64), 256: (256, 64, 32), 512: (256, 64, 16)}


def use_flash_attention(n: int, m: int, device) -> bool:
    if os.environ.get("DS_FLASH_ATTN") != "1":
        return False
    return (n == m and n >= 1024 and n % 128 == 0
            and torch.device(device).type == "cuda")


def head_bucket(d: int) -> int:
    """The compile-time head-dim bucket the kernels pad d up to."""
    return next(b for b in _BUCKETS if d <= b)


def kernel_variant(dtype, d: int) -> str:
    """"tc" (tensor cores) or "scalar" (CUDA cores) for the three kernels,
    from the operand type and head dim alone."""
    return "tc" if dtype == torch.bfloat16 and d % 16 == 0 else "scalar"


def fwd_config(dtype, d: int) -> dict:
    """The forward kernel's variant and tiling (mirrors csrc/flash_fwd.cu):
    bucket, query rows (bq) and keys (bk) per block, threads per CTA and
    dynamic shared-memory bytes."""
    D, variant = head_bucket(d), kernel_variant(dtype, d)
    if variant == "scalar":
        nt, bq, bk = _SCALAR_FWD[D]
        smem = 4 * ((bq + 2 * bk) * (D + 1) + bq * (bk + 1) + 2 * bq)
        design = "scalar"
    elif D == 64:    # wgmma: two warpgroups of 64 rows, P stays in registers
        nt, bq, bk = 256, 128, 64
        smem = (bq + 4 * bk) * D * 2 + 1024
        design = "tc_wgmma"
    else:            # mma.sync: output columns split over two warps per 16 rows
        nt, bq, bk = 256, 64, 32
        smem = (bq + 4 * bk) * D * 2 + bq * (bk + 8) * 2 + 2 * bq * 4
        design = "tc_split"
    return dict(variant=variant, design=design, bucket=D, bq=bq, bk=bk, threads=nt, smem=smem)


def dkv_config(dtype, d: int) -> dict:
    """The dK/dV kernel's variant and tiling (mirrors
    csrc/flash_bwd_dkv.cu)."""
    D, variant = head_bucket(d), kernel_variant(dtype, d)
    if variant == "scalar":
        nt, bq, bk = _SCALAR_DKV[D]
        smem = 4 * ((2 * bk + 2 * bq) * (D + 1) + 2 * bq * (bk + 1) + 3 * bq)
    else:
        nt, bq, bk = _TC_DKV[D]
        smem = (2 * bk + 4 * bq) * D * 2 + 2 * bk * (bq + 8) * 2
    return dict(variant=variant, design=variant, bucket=D, bq=bq, bk=bk, threads=nt, smem=smem)


def dq_config(dtype, d: int) -> dict:
    """The dQ kernel's variant and tiling (mirrors csrc/flash_bwd_dq.cu)."""
    D, variant = head_bucket(d), kernel_variant(dtype, d)
    if variant == "scalar":
        nt, bq, bk = _SCALAR_DQ[D]
        smem = 4 * ((2 * bq + 2 * bk) * (D + 1) + bq * (bk + 1) + 3 * bq)
    else:
        nt, bq, bk = _TC_DQ[D]
        smem = (2 * bq + 4 * bk) * D * 2 + bq * (bk + 8) * 2
    return dict(variant=variant, design=variant, bucket=D, bq=bq, bk=bk, threads=nt, smem=smem)


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


def _strides(t):
    """(batch, head, row) element strides of a [b, h, n, d] tensor as the
    launcher takes them (0 for a dimension of size 1)."""
    return (ctypes.c_longlong * 3)(*(s if z > 1 else 0 for s, z in zip(t.stride(), t.shape[:3])))


def require_rows(t, name: str, dtype, shape, variant: str) -> None:
    """Raise unless t is a CUDA [b, h, n, d] view the forward kernel takes:
    unit stride in d, and for the tensor-core variant 16-byte aligned rows."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.stride(3) != 1:
        raise ValueError(f"{name}: expected unit stride in the head dim, got {t.stride()}")
    if variant == "tc" and (t.data_ptr() % 16 or any(s % 8 for s in _strides(t))):
        raise ValueError(f"{name}: rows must be 16-byte aligned, got strides {t.stride()}")


def launch_fwd(q, k, v, o, l, m, scale: float) -> None:
    """The forward kernel alone, into preallocated o, l, m. q, k, v, o
    may be strided in batch, head and row."""
    b, h, n, d = q.shape
    tc = kernel_variant(q.dtype, d) == "tc"
    code = kernels.lib().ds_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), l.data_ptr(), m.data_ptr(),
        b, h, n, d, _strides(q), _strides(k), _strides(v), _strides(o), float(scale),
        int(q.dtype == torch.bfloat16), int(tc), kernels.stream_ptr(q.device))
    kernels.check(code, "flash_fwd")
    kernels.COUNTS["flash_fwd"] += 1
    kernels.COUNTS["flash_fwd.tc"] += int(tc)


def launch_bwd_dkv(q, k, v, l, m, do, di, dk, dv, scale: float) -> None:
    """The dK/dV kernel alone, into preallocated dk, dv."""
    b, h, n, d = q.shape
    tc = kernel_variant(q.dtype, d) == "tc"
    code = kernels.lib().ds_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), l.data_ptr(), m.data_ptr(), do.data_ptr(),
        di.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, n, d, float(scale),
        int(q.dtype == torch.bfloat16), int(tc), kernels.stream_ptr(q.device))
    kernels.check(code, "flash_bwd_dkv")
    kernels.COUNTS["flash_bwd_dkv"] += 1
    kernels.COUNTS["flash_bwd_dkv.tc"] += int(tc)


def launch_bwd_dq(q, k, v, l, m, do, di, dq, scale: float) -> None:
    """The dQ kernel alone, into a preallocated dq."""
    b, h, n, d = q.shape
    tc = kernel_variant(q.dtype, d) == "tc"
    code = kernels.lib().ds_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), l.data_ptr(), m.data_ptr(), do.data_ptr(),
        di.data_ptr(), dq.data_ptr(), b * h, n, d, float(scale),
        int(q.dtype == torch.bfloat16), int(tc), kernels.stream_ptr(q.device))
    kernels.check(code, "flash_bwd_dq")
    kernels.COUNTS["flash_bwd_dq"] += 1
    kernels.COUNTS["flash_bwd_dq.tc"] += int(tc)


def flash_fwd(q, k, v, scale: float):
    """Forward kernel on CUDA tensors, plain version on CPU tensors.
    Returns (o, l, m); on CUDA o is [b, h, n, d] laid out as [b, n, h, d]."""
    check_shapes(q, k, v)
    if q.device.type != "cuda":
        return flash_attention_fwd_plain(q, k, v, scale)
    b, h, n, d = q.shape
    variant = kernel_variant(q.dtype, d)
    for name, t in (("q", q), ("k", k), ("v", v)):
        require_rows(t, name, q.dtype, q.shape, variant)
    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    l = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    launch_fwd(q, k, v, o, l, m, scale)
    return o, l, m


def flash_bwd(q, k, v, o, l, m, do, scale: float):
    """Both backward kernels on CUDA tensors (dK/dV, then dQ), the plain
    version on CPU tensors. di comes from the stored output. Returns
    (dq, dk, dv)."""
    di = (o.float() * do.float()).sum(-1).contiguous()
    if q.device.type != "cuda":
        return flash_attention_bwd_plain(q, k, v, l, m, do, di, scale)
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
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
        dq, dk, dv = flash_bwd(q, k, v, o, l, m, do, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: float):
    """softmax(scale * q k^T) v on [b, h, n, d] through K4. q, k, v may be
    any views with unit stride in d."""
    return FlashAttention.apply(q, k, v, float(scale))
