"""Tile binning: the tile-sorted, depth-ordered entry table + chunk metadata.

Port of dreamscene_tpu/ops/binning.py `bin_splats` with the same contract
and bit-equal integer outputs:
  1. touched-tile rects (CUDA getRect, tightened to the ellipse AABB at the
     alpha = 1/255 level) and a STABLE depth sort with entry-less splats
     forced to the tail (u32 key, empty flag in bit 31; sorted here as
     int64 copies);
  2. exclusive entry offsets per rank and ragged expansion into a fixed
     `capacity` entry table (kernel K3, ops/expand.py), with the capsule
     cull re-keying unreachable entries to the trash tile;
  3. a stable sort of the packed (tile << shift | rank) keys (u32, sorted
     as int64) carrying the entry index and splat id;
  4. per-chunk metadata: each tile's run starts at its first sorted entry
     rounded down to a multiple of ALIGN and is cut into `chunk`-wide
     windows [lo, hi);
  5. `pos_of_entry`, the grad-table column of each expansion entry, for the
     rasterizer's sort-free gradient reduction.
The capsule channels go into rank order through `ops/gather.py`'s
`row_gather_i32`, the counterpart of the JAX package's uint16-halves
gather. Overflow past `capacity` drops the farthest splats
(`n_dropped`).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from dreamscene_tpu_torch.ops.expand import expand_entries
from dreamscene_tpu_torch.ops.gather import row_gather_i32

# Tile shape: an explicit argument, else DS_TILE_W / DS_TILE_H, else 32x16,
# as the JAX package resolves it (its ops/binning.py:61-75). The variables
# are read once, at import: set them before the first import, to the same
# values in every process. DS_TILE_W=16 DS_TILE_H=16 gives the CUDA
# reference's 16x16 tiles.
DEFAULT_TILE_W = int(os.environ.get("DS_TILE_W", "32"))
DEFAULT_TILE_H = int(os.environ.get("DS_TILE_H", "16"))
ALIGN = 128


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def resolve_tile(tile_w, tile_h):
    return (DEFAULT_TILE_W if tile_w is None else tile_w,
            DEFAULT_TILE_H if tile_h is None else tile_h)


class BinnedSplats(NamedTuple):
    rank_sorted: torch.Tensor   # [capacity] int32 depth rank of sorted entry
    gid_sorted: torch.Tensor    # [capacity] int32 original splat id of entry
    n_chunks_used: torch.Tensor  # [] int32 live chunk count
    chunk_tile: torch.Tensor    # [n_chunks] int32 tile id (n_tiles = trash)
    chunk_s0: torch.Tensor      # [n_chunks] int32 ALIGN-aligned sorted column
    chunk_lo: torch.Tensor      # [n_chunks] int32 first live lane of chunk
    chunk_hi: torch.Tensor      # [n_chunks] int32 end of live lanes
    chunk_first: torch.Tensor   # [n_chunks+1] int32 1 = chunk starts a tile
    n_entries: torch.Tensor     # [] int32 entries before padding
    n_dropped: torch.Tensor     # [] int32 entries lost to capacity overflow
    perm: torch.Tensor          # [N] int32 depth rank -> original splat id
    inv_perm: torch.Tensor      # [N] int32 original splat id -> depth rank
    surv_counts: torch.Tensor   # [N] int32 surviving entries per rank
    seg_starts: torch.Tensor    # [N] int32 expansion-order segment start
    pos_of_entry: torch.Tensor  # [capacity] int32 grad-table position


def max_chunks(capacity: int, n_tiles: int, chunk: int) -> int:
    """Static chunk-count bound (see the JAX docstring): capacity/chunk
    plus each tile's alignment slack, +1 for the zeroed chunk."""
    return (cdiv(capacity, chunk) + cdiv(n_tiles * (ALIGN - 1 + chunk - 1), chunk) + 1)


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _capsule_params(means2d, conics, opacities):
    """Per-splat capsule channels for the expand kernel's entry cull:
    6 x 12-bit fields (ellipse mid, major half-axis vector, minor radius,
    no-cull flag) packed into 3 int32 (see the JAX docstring)."""
    ca, cb, cc = conics[:, 0], conics[:, 1], conics[:, 2]
    opa = opacities.float()
    tq = 2.0 * torch.log(255.0 * torch.clamp_min(opa, 1e-30))
    half_tr = 0.5 * (ca + cc)
    root = torch.sqrt(torch.clamp_min(0.25 * (ca - cc) ** 2 + cb * cb, 0.0))
    lam_min = torch.clamp_min(half_tr - root, 1e-12)
    lam_max = torch.clamp_min(half_tr + root, 1e-12)
    tq_pos = torch.clamp_min(tq, 0.0)
    big_a = torch.sqrt(tq_pos / lam_min)
    big_b = torch.sqrt(tq_pos / lam_max)
    ex = cb
    ey = lam_min - ca
    en = torch.sqrt(ex * ex + ey * ey)
    degen = en < 1e-8
    ux = torch.where(degen, torch.ones_like(ex), ex / torch.clamp_min(en, 1e-30))
    uy = torch.where(degen, torch.zeros_like(ey), ey / torch.clamp_min(en, 1e-30))
    vx = ux * big_a
    vy = uy * big_a
    mx = means2d[:, 0].float()
    my = means2d[:, 1].float()
    no_cull = ((torch.abs(mx) > 1023.0) | (torch.abs(my) > 1023.0)
               | (big_a > 1022.0) | ~torch.isfinite(big_a)
               | ~torch.isfinite(vx) | ~torch.isfinite(vy))

    def q_mid(x):
        return torch.clamp(torch.round(x * 2.0) + 2048.0, 0, 4095)

    def q_out(x):
        return torch.clamp(torch.sign(x) * torch.ceil(torch.abs(x) * 2.0) + 2048.0, 0, 4095)

    b_enc = torch.clamp(torch.ceil(big_b * 2.0) + 1.0, 0, 4095)
    ch0 = q_mid(mx) * 4096.0 + q_mid(my)
    ch1 = q_out(vx) * 4096.0 + q_out(vy)
    ch2 = b_enc * 4096.0 + no_cull.float()
    return _i32(ch0), _i32(ch1), _i32(ch2)


def bin_splats(means2d, depths, radii, visible, width: int, height: int,
               capacity: int, chunk: int = 256, conics=None, opacities=None,
               rank_drop_override: int | None = None, tile_w: int | None = None,
               tile_h: int | None = None) -> BinnedSplats:
    """Build the tile-sorted, depth-ordered entry table + chunk metadata.
    With conics/opacities, tiles a splat cannot reach at alpha >= 1/255 are
    left out (AABB tightening) or re-keyed to the trash tile (capsule
    cull); both only remove entries the compositing zeroes anyway."""
    tile_w, tile_h = resolve_tile(tile_w, tile_h)
    ex = expand_args(means2d, depths, radii, visible, width, height, capacity,
                     conics, opacities, rank_drop_override, tile_w, tile_h)
    key_i32, gid = expand_entries(**ex["kwargs"])
    return _finish(ex, key_i32, gid, capacity, chunk)


def expand_args(means2d, depths, radii, visible, width: int, height: int,
                capacity: int, conics=None, opacities=None,
                rank_drop_override: int | None = None, tile_w: int = 32,
                tile_h: int = 16) -> dict:
    """Steps 1-2 of binning: tile rects, the depth sort and the entry
    offsets. Returns the keyword arguments of `expand_entries` (under
    "kwargs") and the rank-order state the later steps need."""
    n = means2d.shape[0]
    dev = means2d.device
    tiles_x = cdiv(width, tile_w)
    tiles_y = cdiv(height, tile_h)
    n_tiles = tiles_x * tiles_y

    means2d = means2d.detach()
    depths = depths.detach()
    mx, my = means2d[:, 0], means2d[:, 1]
    r = radii.float()
    use_cull = conics is not None and opacities is not None
    vis = visible.bool()
    if use_cull:
        conics = conics.detach()
        opacities = opacities.detach()
        ca, cb, cc = conics[:, 0], conics[:, 1], conics[:, 2]
        tq = 2.0 * torch.log(255.0 * torch.clamp_min(opacities.float(), 1e-30))
        det = torch.clamp_min(ca * cc - cb * cb, 1e-24)
        tq_pos = torch.clamp_min(tq, 0.0)
        hx = torch.sqrt(tq_pos * torch.clamp_min(cc, 0.0) / det) + 0.6
        hy = torch.sqrt(tq_pos * torch.clamp_min(ca, 0.0) / det) + 0.6
        vis = vis & (tq > 0)

    def tclip(x, hi):
        return _i32(torch.clamp(x, 0, hi))

    x0 = tclip(torch.floor((mx - r) / tile_w), tiles_x)
    y0 = tclip(torch.floor((my - r) / tile_h), tiles_y)
    x1 = tclip(torch.floor((mx + r + tile_w - 1) / tile_w), tiles_x)
    y1 = tclip(torch.floor((my + r + tile_h - 1) / tile_h), tiles_y)
    if use_cull:
        x0 = torch.maximum(x0, tclip(torch.floor((mx - hx) / tile_w), tiles_x))
        y0 = torch.maximum(y0, tclip(torch.floor((my - hy) / tile_h), tiles_y))
        x1 = torch.minimum(x1, tclip(torch.floor((mx + hx) / tile_w) + 1, tiles_x))
        y1 = torch.minimum(y1, tclip(torch.floor((my + hy) / tile_h) + 1, tiles_y))
    zero = torch.zeros_like(x0)
    nx = torch.where(vis, x1 - x0, zero)
    ny = torch.where(vis, y1 - y0, zero)
    count0 = nx * ny
    assert tiles_x <= 255, "image wider than 255 tiles: widen basenx packing"
    basenx0 = (y0 * tiles_x + x0) * 256 + nx

    # stable depth sort, entry-less splats forced to the tail (bit 31)
    depth_bits = torch.clamp_min(depths, 1e-6).float().view(torch.int32).long()
    dkey = depth_bits | ((count0 == 0).long() << 31)
    perm = torch.sort(dkey, stable=True).indices
    basenx = basenx0[perm]
    count = count0[perm]
    caps = None
    if use_cull:
        caps0 = torch.stack(_capsule_params(means2d, conics, opacities), dim=1)
        caps = tuple(row_gather_i32(caps0, perm).t().contiguous())       # rank order
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    inv_perm = torch.empty_like(idx)
    inv_perm[perm] = idx
    perm = _i32(perm)

    offsets = _i32(torch.cumsum(count, 0) - count)
    raw_total = offsets[-1] + count[-1]
    total = torch.clamp_max(raw_total, capacity)
    n_dropped = torch.clamp_min(raw_total - capacity, 0)

    shift = max(int(n - 1).bit_length(), 1)
    rank_drop = max(0, int(n_tiles).bit_length() + shift - 32)
    if rank_drop_override is not None:
        rank_drop = rank_drop_override
    shift -= rank_drop
    assert shift >= 1, "image too large: tile bits alone exceed the key"
    return dict(
        kwargs=dict(offsets=offsets.contiguous(), basenx=basenx.contiguous(),
                    perm=perm.contiguous(), n_entries=_i32(total),
                    capacity=capacity, n=n, n_tiles=n_tiles, tiles_x=tiles_x,
                    shift=shift, rank_drop=rank_drop, caps=caps,
                    tile_w=tile_w, tile_h=tile_h),
        count=count, inv_perm=inv_perm, n_dropped=n_dropped)


def _finish(ex: dict, key_i32, gid, capacity: int, chunk: int) -> BinnedSplats:
    """Steps 3-5 of binning, from the expanded entry keys."""
    kw = ex["kwargs"]
    offsets, perm, total = kw["offsets"], kw["perm"], kw["n_entries"]
    count, inv_perm, n_dropped = ex["count"], ex["inv_perm"], ex["n_dropped"]
    n_tiles, shift, rank_drop = kw["n_tiles"], kw["shift"], kw["rank_drop"]
    dev = offsets.device
    n_chunks = max_chunks(capacity, n_tiles, chunk)

    # stable entry sort by the u32-reinterpreted key
    key_u = key_i32.long() & 0xFFFFFFFF
    key_s, e_s = torch.sort(key_u, stable=True)
    gid_s = gid[e_s]
    tile_s = _i32(key_s >> shift)
    rank_s = _i32((key_s & ((1 << shift) - 1)) << rank_drop)

    # per-chunk metadata from per-tile runs
    assert chunk % ALIGN == 0
    tiles = torch.arange(n_tiles + 1, dtype=torch.int32, device=dev)
    tile_first = _i32(torch.searchsorted(tile_s, tiles, right=False))
    counts_t = tile_first[1:] - tile_first[:-1]
    s0_full = (tile_first // ALIGN) * ALIGN
    off_t = tile_first[:-1] - s0_full[:-1]
    chunks_per_tile = (-((-(off_t + counts_t)) // chunk)) * (counts_t > 0)
    chunk_base = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                            _i32(torch.cumsum(chunks_per_tile, 0))])
    u_used = chunk_base[-1]

    u = torch.arange(n_chunks, dtype=torch.int32, device=dev)
    chunk_tile = _i32(torch.searchsorted(chunk_base, u, right=True)) - 1
    in_use = u < u_used
    chunk_tile = torch.where(in_use, chunk_tile, torch.full_like(chunk_tile, n_tiles))
    tclip_idx = torch.clamp(chunk_tile, 0, n_tiles - 1).long()
    k = u - chunk_base[:-1][tclip_idx]
    g_s0 = s0_full[:-1][tclip_idx]
    g_off = off_t[tclip_idx]
    g_cnt = counts_t[tclip_idx]
    zeros_u = torch.zeros_like(u)
    chunk_s0 = torch.where(in_use, g_s0 + k * chunk, zeros_u)
    chunk_lo = torch.where(in_use, torch.clamp(g_off - k * chunk, 0, chunk), zeros_u)
    chunk_hi = torch.where(in_use, torch.clamp(g_off + g_cnt - k * chunk, 0, chunk), zeros_u)
    chunk_first = _i32(torch.where(in_use, k == 0, u == u_used))
    chunk_first = torch.cat([chunk_first, torch.ones((1,), dtype=torch.int32, device=dev)])

    # grad-table position of each expansion entry
    e = torch.arange(capacity, dtype=torch.int32, device=dev)
    padfix = chunk_base * chunk - s0_full
    pvals = padfix - torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev), padfix[:-1]])
    pdelta = torch.zeros((capacity + 1,), dtype=torch.int32, device=dev)
    pdelta.index_add_(0, tile_first.long(), pvals)
    pos_sorted = e + _i32(torch.cumsum(pdelta[:capacity], 0))
    pos_of_entry = torch.empty_like(pos_sorted)
    pos_of_entry[e_s] = pos_sorted
    pos_of_entry = torch.clamp(pos_of_entry, 0, n_chunks * chunk - 1)

    surv = torch.clamp(torch.minimum(offsets + count, total) - offsets,
                       min=torch.zeros_like(count), max=count)

    return BinnedSplats(
        rank_sorted=rank_s, gid_sorted=gid_s, n_chunks_used=u_used,
        chunk_tile=chunk_tile.contiguous(), chunk_s0=chunk_s0.contiguous(),
        chunk_lo=chunk_lo.contiguous(), chunk_hi=chunk_hi.contiguous(),
        chunk_first=chunk_first, n_entries=_i32(total), n_dropped=_i32(n_dropped),
        perm=perm, inv_perm=inv_perm, surv_counts=_i32(surv),
        seg_starts=offsets, pos_of_entry=pos_of_entry,
    )
