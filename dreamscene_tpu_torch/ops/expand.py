"""Ragged entry expansion for tile binning: kernel K3 and its plain version.

Port of dreamscene_tpu/ops/expand.py `expand_entries`. Splat r (depth-rank
order) owns the entry run [offsets[r], offsets[r] + count[r]); for every
entry slot e < capacity this returns the packed sort key
`tile << shift | (rank >> rank_drop)` and the splat's original id. Slots
at or past `n_entries`, and (with capsule channels) slots whose tile the
splat cannot reach at alpha >= 1/255, get the trash tile `n_tiles`.

The JAX kernel recovers each slot's owner inside a window of splat rows
per block of `block` slots; for slots past the last entry that window
decides which (empty) splat owns them. Those slots still carry a rank and
a gid into the entry sort, so both versions here reproduce the window
limit (`_window_ends`) to stay bit-equal; the CUDA kernel derives the same
window ends per block on the card.

CUDA tensors go to csrc/expand.cu, one launch per call; CPU tensors to
`expand_entries_plain`.

The window block length is read from `DS_EXPAND_BLOCK` once, at import,
as the JAX package's ops/binning.py reads it (default 2048): set it before
the first import, to the same value in every process. K3 takes any
positive multiple of 128 slots, as the JAX kernel does.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from dreamscene_tpu_torch import kernels

BLOCK = int(os.environ.get("DS_EXPAND_BLOCK", "2048"))   # slots per window block
SLOTS = 256         # slots per CUDA block of K3 where it divides the block (csrc/expand.cu)
MIN_SLOTS = 128     # else 128: the window block's granularity
CAP_PAD = 0.3       # cull-test half-extent padding beyond (tile/2 - 0.5) px


def _window_ends(offsets: torch.Tensor, capacity: int, block: int) -> torch.Tensor:
    """Per block of slots, the end of the splat-row window the JAX kernel
    scans: w0a + 128 * wlive (expand.py:308-316)."""
    wsize = block + 256
    n_blocks = -(-capacity // block)
    bstarts = torch.arange(n_blocks, dtype=torch.int32, device=offsets.device) * block
    ws0 = torch.clamp_min(
        torch.searchsorted(offsets, bstarts, right=True).to(torch.int32) - 1, 0)
    w0a = (ws0 // 128) * 128
    ws_end = torch.searchsorted(offsets, bstarts + (block - 1), right=True).to(torch.int32)
    wlive = torch.clamp(-((w0a - ws_end) // 128), 1, wsize // 128)
    return (w0a + 128 * wlive).to(torch.int32).contiguous()


def _cull_consts(tile_w: int, tile_h: int, tiles_x: int):
    return dict(
        cxo=float(np.float32(tile_w / 2.0 - 0.5)),
        cyo=float(np.float32(tile_h / 2.0 - 0.5)),
        hwx=float(np.float32(tile_w / 2.0 - 0.5 + CAP_PAD)),
        hwy=float(np.float32(tile_h / 2.0 - 0.5 + CAP_PAD)),
        inv_tiles_x=float(np.float32(1.0) / np.float32(tiles_x)),
    )


def expand_entries(offsets, basenx, perm, n_entries, capacity: int, n: int,
                   n_tiles: int, tiles_x: int, shift: int, rank_drop: int = 0,
                   caps=None, block: int = BLOCK, tile_w: int = 16,
                   tile_h: int = 16):
    """Per-entry (sort_key, original splat id), each [capacity] int32.
    offsets/basenx/perm and the 3 capsule channels are [N] int32 in rank
    order; n_entries is a one-element int32 tensor."""
    if offsets.device.type == "cpu":
        return expand_entries_plain(
            offsets, basenx, perm, n_entries, capacity, n, n_tiles, tiles_x,
            shift, rank_drop, caps, block, tile_w, tile_h)
    return launch_expand(*prepare_expand(
        offsets, basenx, perm, n_entries, capacity, n, n_tiles, tiles_x, shift,
        rank_drop, caps, block, tile_w, tile_h))


class ExpandGeo(ctypes.Structure):
    """The per-geometry scalars of a K3 launch (csrc/expand.cu, same fields
    in the same order)."""
    _fields_ = ([(k, ctypes.c_int) for k in (
        "capacity", "n", "n_tiles", "tiles_x", "shift", "rank_drop", "block", "use_cull",
        "tile_w", "tile_h")]
        + [(k, ctypes.c_float) for k in ("cxo", "cyo", "hwx", "hwy", "inv_tiles_x")])


@functools.lru_cache(maxsize=64)
def expand_geometry(capacity, n, n_tiles, tiles_x, shift, rank_drop, block, use_cull,
                    tile_w, tile_h) -> ExpandGeo:
    """The launch's constants, built once per geometry."""
    if block < MIN_SLOTS or block % MIN_SLOTS:
        raise ValueError(f"block of {block} slots (DS_EXPAND_BLOCK): K3 takes a positive "
                         f"multiple of {MIN_SLOTS}")
    c = _cull_consts(tile_w, tile_h, tiles_x)
    return ExpandGeo(capacity, n, n_tiles, tiles_x, shift, rank_drop, block, int(use_cull),
                     tile_w, tile_h, c["cxo"], c["cyo"], c["hwx"], c["hwy"], c["inv_tiles_x"])


def prepare_expand(offsets, basenx, perm, n_entries, capacity, n, n_tiles, tiles_x,
                   shift, rank_drop, caps, block, tile_w, tile_h):
    """Validate and allocate: the launcher's arguments, and the (key, gid)
    outputs it fills followed by the geometry the arguments point to. The
    kernel derives the window ends and clamps the offsets itself, so no
    torch op runs here but the two allocations."""
    use_cull = caps is not None
    caps = tuple(caps) if use_cull else (offsets,) * 3
    for name, t in (("offsets", offsets), ("basenx", basenx), ("perm", perm),
                    ("caps0", caps[0]), ("caps1", caps[1]), ("caps2", caps[2])):
        kernels.require(t, name, torch.int32, (n,))
    kernels.require(n_entries, "n_entries", torch.int32)
    if n_entries.numel() != 1:
        raise ValueError(f"n_entries: expected one element, got shape {tuple(n_entries.shape)}")
    geo = expand_geometry(capacity, n, n_tiles, tiles_x, shift, rank_drop, block, use_cull,
                          tile_w, tile_h)
    dev = offsets.device
    key = torch.empty((capacity,), dtype=torch.int32, device=dev)
    gid = torch.empty((capacity,), dtype=torch.int32, device=dev)
    args = (offsets.data_ptr(), basenx.data_ptr(), perm.data_ptr(), caps[0].data_ptr(),
            caps[1].data_ptr(), caps[2].data_ptr(), n_entries.data_ptr(), key.data_ptr(),
            gid.data_ptr(), ctypes.addressof(geo), kernels.stream_ptr(dev))
    return args, (key, gid, geo)


def launch_expand(args, outs):
    """Launch K3 on the current stream; returns (key, gid)."""
    kernels.check(kernels.lib().ds_expand_entries(*args), "expand_entries")
    kernels.COUNTS["expand_entries"] += 1
    return outs[0], outs[1]


def expand_entries_plain(offsets, basenx, perm, n_entries, capacity: int,
                         n: int, n_tiles: int, tiles_x: int, shift: int,
                         rank_drop: int = 0, caps=None, block: int = BLOCK,
                         tile_w: int = 16, tile_h: int = 16):
    """The same function in plain PyTorch (vectorized over slots)."""
    dev = offsets.device
    f32 = torch.float32
    offs_c = torch.clamp_max(offsets, capacity).contiguous()
    e = torch.arange(capacity, dtype=torch.int32, device=dev)
    wend = _window_ends(offsets, capacity, block)
    cnt = torch.searchsorted(offs_c, e, right=True).to(torch.int32)
    d = torch.clamp_min(torch.minimum(cnt, wend[e // block]) - 1, 0).long()
    bn = basenx[d]
    slot_e = e - offsets[d]
    base_t = bn >> 8
    gnx = torch.clamp_min(bn & 255, 1)
    qy = torch.div(slot_e, gnx, rounding_mode="floor")
    tile = base_t + qy * tiles_x + (slot_e - qy * gnx)
    valid = e < n_entries

    if caps is not None:
        c = _cull_consts(tile_w, tile_h, tiles_x)
        ch0, ch1, ch2 = (caps[j][d] for j in range(3))
        midx = ((ch0 >> 12) - 2048).to(f32) * 0.5
        midy = ((ch0 & 4095) - 2048).to(f32) * 0.5
        vx = ((ch1 >> 12) - 2048).to(f32) * 0.5
        vy = ((ch1 & 4095) - 2048).to(f32) * 0.5
        big_b = (ch2 >> 12).to(f32) * 0.5
        no_cull = (ch2 & 4095) > 0
        tilef = tile.to(f32)
        ty = torch.floor(tilef * c["inv_tiles_x"])
        tx = tilef - ty * float(tiles_x)
        dx = tx * float(tile_w) + c["cxo"] - midx
        dy = ty * float(tile_h) + c["cyo"] - midy
        v2 = vx * vx + vy * vy
        iv2 = 1.0 / torch.clamp_min(v2, 0.25)
        ib2 = 1.0 / torch.clamp_min(big_b * big_b, 0.25)
        ea = (vx * vx * iv2 + vy * vy * ib2) * iv2
        eb = (vx * vy * iv2 - vx * vy * ib2) * iv2
        ec = (vy * vy * iv2 + vx * vx * ib2) * iv2
        lxe, uxe = dx - c["hwx"], dx + c["hwx"]
        lye, uye = dy - c["hwy"], dy + c["hwy"]
        inside = (lxe <= 0.0) & (uxe >= 0.0) & (lye <= 0.0) & (uye >= 0.0)

        def clip(x, lo, hi):
            return torch.minimum(torch.maximum(x, lo), hi)

        def emin_edge_x(cst):
            dye = clip(-eb * cst / torch.clamp_min(ec, 1e-30), lye, uye)
            return ea * cst * cst + 2.0 * eb * cst * dye + ec * dye * dye

        def emin_edge_y(cst):
            dxe = clip(-eb * cst / torch.clamp_min(ea, 1e-30), lxe, uxe)
            return ea * dxe * dxe + 2.0 * eb * dxe * cst + ec * cst * cst

        emin = torch.minimum(
            torch.minimum(emin_edge_x(lxe), emin_edge_x(uxe)),
            torch.minimum(emin_edge_y(lye), emin_edge_y(uye)),
        )
        emin = torch.where(inside, torch.zeros_like(emin), emin)
        thresh = 1.001 + 0.55 * ib2
        valid = valid & (no_cull | (emin <= thresh))

    tile_i = torch.where(valid, tile, torch.full_like(tile, n_tiles)).long()
    key = ((tile_i << shift) | (d >> rank_drop)) & 0xFFFFFFFF
    key = torch.where(key >= 2**31, key - 2**32, key).to(torch.int32)
    gid = torch.clamp(perm[d], 0, n - 1).to(torch.int32)
    return key, gid
