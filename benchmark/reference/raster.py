"""The rasterizer in plain PyTorch: the benchmark's frozen reference of
projection, SH, tile binning, ragged entry expansion and front-to-back
compositing with its hand-derived backward.

A copy of the program's plain versions, with every path to a hand-written
kernel taken out: the same binning contract (stable depth sort, entry table
of a fixed `capacity` that drops the farthest splats' entries past it,
chunk metadata, capsule cull), the same compositing semantics (alpha =
min(0.99, opa*exp(power)), zero when power > 0 or alpha < 1/255; a pixel
applies, chunk by chunk, the prefix of entries that keeps T >= 1e-4) and the
same gradient reduction. It runs on whatever device its inputs lie on.
`render` is the program's `render` signature without `device`.

The tile shape defaults to DS_TILE_W x DS_TILE_H (32 x 16 when unset) and
the expansion window block to DS_EXPAND_BLOCK (2048), read at import as the
program reads them.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.gather import row_gather, row_gather_i32
from benchmark.reference.projection import project_gaussians

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
TRANSMITTANCE_EPS = 1e-4
F_MX, F_MY, F_CA, F_CB, F_CC, F_OPA, F_R, F_G, F_B, F_DEPTH = range(10)
N_LIVE_FIELDS = 10
REC_WIDTH = 16
A_R, A_G, A_B, A_DEPTH, A_T, A_LIVE = range(6)
ACC_ROWS = 8
CARRY_ROWS = 5

# elements of one [tiles, pixels, lanes] block in the plain versions
_PLAIN_BLOCK_ELEMS = 1 << 24


BLOCK = int(os.environ.get("DS_EXPAND_BLOCK", "2048"))   # slots per window block
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
    key_i32, gid = expand_entries_plain(**ex["kwargs"])
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


def _slots(chunk_tile, n_chunks_used):
    """Chunk ids grouped by their position k within the tile: slot k
    holds every tile's k-th chunk (one chunk per tile per slot)."""
    n_u = int(n_chunks_used)
    ct = chunk_tile[:n_u].long()
    first = torch.searchsorted(ct, ct, right=False)
    k = torch.arange(n_u, device=ct.device) - first
    n_slots = int(k.max()) + 1 if n_u else 0
    return [torch.nonzero(k == s).flatten() for s in range(n_slots)]


def _chunk_block(records_t, us, chunk_tile, chunk_s0, chunk_lo, chunk_hi,
                 t_carry, tiles_x, chunk, tile_w, tile_h):
    """Forward math of chunks `us` (one per tile) as [G, P, L] blocks."""
    dev = records_t.device
    lanes = torch.arange(chunk, device=dev)
    cols = chunk_s0[us].long()[:, None] + lanes[None, :]          # [G, L]
    rec = records_t[:N_LIVE_FIELDS][:, cols].permute(1, 0, 2)     # [G, 10, L]
    lo = chunk_lo[us].long()[:, None]
    hi = chunk_hi[us].long()[:, None]
    lanemask = (lanes[None, :] >= lo) & (lanes[None, :] < hi)     # [G, L]
    t = chunk_tile[us].long()
    p = torch.arange(tile_w * tile_h, device=dev)
    px = ((t % tiles_x) * tile_w)[:, None] + (p % tile_w)[None, :]
    py = ((t // tiles_x) * tile_h)[:, None] + (p // tile_w)[None, :]
    px = px.float()[:, :, None]
    py = py.float()[:, :, None]                                   # [G, P, 1]

    def row(f):
        return rec[:, f, None, :]                                 # [G, 1, L]

    dx = row(F_MX) - px
    dy = row(F_MY) - py
    power = -0.5 * (row(F_CA) * dx * dx + row(F_CC) * dy * dy) - row(F_CB) * dx * dy
    ex = torch.exp(power)
    raw = row(F_OPA) * ex
    alpha = torch.clamp_max(raw, ALPHA_MAX)
    alpha = torch.where((power > 0.0) | (raw < ALPHA_MIN) | ~lanemask[:, None, :],
                        torch.zeros_like(alpha), alpha)
    q = 1.0 - alpha
    # T entry by entry, t <- t * q, in K1's order: a scan (cumprod) would
    # associate the product otherwise, and its last ulp can carry T across
    # the 1e-4 stop on one side only (seen at 1920x1080 on the card). Lanes
    # outside [min lo, max hi) have q = 1 and leave T as it is.
    l0, l1 = int(lo.min()), int(hi.max())
    t, steps = t_carry, []
    for l in range(l0, l1):
        t = t * q[:, :, l]
        steps.append(t)
    t_incl = torch.cat([t_carry[:, :, None].expand(-1, -1, l0), torch.stack(steps, dim=2),
                        t[:, :, None].expand(-1, -1, chunk - l1)], dim=2)
    t_excl = torch.cat([t_carry[:, :, None], t_incl[:, :, :-1]], dim=2)
    applied = torch.cumprod((t_incl >= TRANSMITTANCE_EPS).to(torch.int8), dim=2).bool()
    contrib = torch.where(applied, t_excl * alpha, torch.zeros_like(alpha))
    t_new = torch.where(applied, t_incl, t_carry[:, :, None]).amin(dim=2)
    t_new = torch.minimum(t_new, t_carry)
    return dict(rec=rec, dx=dx, dy=dy, ex=ex, raw=raw, alpha=alpha, q=q,
                t_excl=t_excl, applied=applied, contrib=contrib, t_new=t_new,
                tiles=t)


def _groups(us, tile_pix, chunk):
    g = max(1, _PLAIN_BLOCK_ELEMS // (tile_pix * chunk))
    return [us[i:i + g] for i in range(0, us.numel(), g)]


def composite_forward_plain(records_t, chunk_tile, chunk_s0, chunk_lo,
                            chunk_hi, n_chunks_used, n_tiles: int,
                            tiles_x: int, chunk: int = 512, tile_w: int = 32,
                            tile_h: int = 16, return_carry: bool = False):
    """The accumulators; with `return_carry` also the carry table (rows of
    chunks that are not live stay zero)."""
    dev = records_t.device
    tile_pix = tile_w * tile_h
    carry = torch.zeros((chunk_tile.shape[0] if return_carry else 0, CARRY_ROWS, tile_pix),
                        device=dev)
    acc = torch.zeros((n_tiles + 1, tile_pix, 4), device=dev)
    t_state = torch.ones((n_tiles + 1, tile_pix), device=dev)
    live = torch.zeros((n_tiles + 1,), device=dev)
    for us in _slots(chunk_tile, n_chunks_used):
        for grp in _groups(us, tile_pix, chunk):
            live_grp = grp[chunk_hi[grp] > chunk_lo[grp]]
            if live_grp.numel() == 0:
                continue
            tiles = chunk_tile[live_grp].long()
            if return_carry:
                carry[live_grp, :4] = acc[tiles].transpose(1, 2)
                carry[live_grp, 4] = t_state[tiles]
            v = _chunk_block(records_t, live_grp, chunk_tile, chunk_s0,
                             chunk_lo, chunk_hi, t_state[tiles], tiles_x,
                             chunk, tile_w, tile_h)
            cd = torch.cat([v["rec"][:, F_R:F_B + 1], v["rec"][:, F_DEPTH:F_DEPTH + 1]], 1)
            acc[tiles] += torch.einsum("gpl,gcl->gpc", v["contrib"], cd)
            t_state[tiles] = v["t_new"]
            live[tiles] += 1.0
    out = torch.zeros((n_tiles + 1, ACC_ROWS, tile_pix), device=dev)
    out[:, A_R:A_DEPTH + 1] = acc.transpose(1, 2)
    out[:, A_T] = t_state
    out[:, A_LIVE] = live[:, None]
    return (out, carry) if return_carry else out


def composite_backward_plain(records_t, chunk_tile, chunk_s0, chunk_lo,
                             chunk_hi, n_chunks_used, final_accums,
                             grad_accums, n_tiles: int, tiles_x: int,
                             chunk: int = 512, tile_w: int = 32,
                             tile_h: int = 16, carry=None):
    """The grad table. Without `carry` the chunks of a tile are walked in
    order, each from the state the one before left. With the carry table
    every chunk starts from its own row instead (T from row 4, the prefix
    as g . rows 0-3), the way K2 does."""
    dev = records_t.device
    tile_pix = tile_w * tile_h
    n_chunks = chunk_tile.shape[0]
    grec = torch.zeros((REC_WIDTH, n_chunks * chunk), device=dev)
    g_rgbd = grad_accums[:, A_R:A_DEPTH + 1].transpose(1, 2)         # [T+1, P, 4]
    c_final = final_accums[:, A_R:A_DEPTH + 1].transpose(1, 2)
    ccar = (c_final * g_rgbd).sum(-1) + grad_accums[:, A_T] * final_accums[:, A_T]
    t_state = torch.ones((n_tiles + 1, tile_pix), device=dev)
    run = torch.zeros((n_tiles + 1, tile_pix), device=dev)
    lanes = torch.arange(chunk, device=dev)
    for us in _slots(chunk_tile, n_chunks_used):
        for grp in _groups(us, tile_pix, chunk):
            live_grp = grp[chunk_hi[grp] > chunk_lo[grp]]
            if live_grp.numel() == 0:
                continue
            tiles = chunk_tile[live_grp].long()
            g = g_rgbd[tiles]                                         # [G, P, 4]
            if carry is None:
                t_in, run_in = t_state[tiles], run[tiles]
            else:
                t_in = carry[live_grp, 4]
                run_in = (carry[live_grp, :4].transpose(1, 2) * g).sum(-1)
            v = _chunk_block(records_t, live_grp, chunk_tile, chunk_s0,
                             chunk_lo, chunk_hi, t_in, tiles_x,
                             chunk, tile_w, tile_h)
            rec, contrib, alpha = v["rec"], v["contrib"], v["alpha"]
            cd = torch.cat([rec[:, F_R:F_B + 1], rec[:, F_DEPTH:F_DEPTH + 1]], 1)
            cg = torch.einsum("gpc,gcl->gpl", g, cd)                  # [G, P, L]
            prefix = run_in[:, :, None] + torch.cumsum(contrib * cg, dim=2)
            suffix = ccar[tiles][:, :, None] - prefix
            galpha = v["t_excl"] * cg - suffix / v["q"]
            keep = v["applied"] & (alpha > 0.0)
            galpha = torch.where(keep, galpha, torch.zeros_like(galpha))
            unclamped = v["raw"] < ALPHA_MAX
            gpower = torch.where(unclamped, galpha * v["raw"], torch.zeros_like(galpha))
            g_opa = torch.where(unclamped, galpha * v["ex"], torch.zeros_like(galpha))
            dx, dy = v["dx"], v["dy"]

            def r(f):
                return rec[:, f, None, :]

            fields = [
                (-gpower * (r(F_CA) * dx + r(F_CB) * dy)).sum(1),
                (-gpower * (r(F_CC) * dy + r(F_CB) * dx)).sum(1),
                (-0.5 * gpower * dx * dx).sum(1),
                (-gpower * dx * dy).sum(1),
                (-0.5 * gpower * dy * dy).sum(1),
                g_opa.sum(1),
            ]
            gcd = torch.einsum("gpl,gpc->gcl", contrib, g)            # [G, 4, L]
            gtab = torch.cat([torch.stack(fields, 1), gcd], 1)        # [G, 10, L]
            cols = live_grp.long()[:, None] * chunk + lanes[None, :]
            grec[:N_LIVE_FIELDS, cols.flatten()] = (
                gtab.permute(1, 0, 2).reshape(N_LIVE_FIELDS, -1))
            run[tiles] = prefix[:, :, -1]
            t_state[tiles] = v["t_new"]
    return grec


def blocked_cumsum(x: torch.Tensor, block: int = 128) -> torch.Tensor:
    """Inclusive cumsum over axis 0, two-level blocked: an in-block cumsum
    plus a recursively blocked carry. A flat fp32 cumsum over ~240K rows
    loses precision; the blocked form keeps each partial sum short (the
    JAX package's `_blocked_cumsum`)."""
    m, w = x.shape
    if m <= block:
        return torch.cumsum(x, dim=0)
    nb = cdiv(m, block)
    xp = torch.cat([x, x.new_zeros((nb * block - m, w))], dim=0)
    inner = torch.cumsum(xp.reshape(nb, block, w), dim=1)
    carry = blocked_cumsum(inner[:, -1, :], block)
    carry = torch.cat([x.new_zeros((1, w)), carry[:-1]], dim=0)
    return (inner + carry[:, None, :]).reshape(nb * block, w)[:m]


class GatherComposite(torch.autograd.Function):
    """Record gather + the plain compositing under one autograd node: the
    chunk-aligned grad table is an internal layout that never leaves this
    function.

    Backward: the plain compositing VJP writes per-entry gradients; entries are gathered into
    expansion order through `pos_of_entry` (masked entries redirected to
    the zeroed chunk n_chunks_used), each rank's contiguous segment is
    reduced with a blocked cumsum difference, and the depth permutation is
    undone with one gather."""

    @staticmethod
    def forward(ctx, rec_n, inv_perm, gid_pad, pos_of_entry, surv, seg_starts,
                chunk_tile, chunk_s0, chunk_lo, chunk_hi, chunk_first,
                n_chunks_used, n_tiles, tiles_x, chunk, tile_w, tile_h):
        records_t = row_gather(rec_n, gid_pad).t().contiguous()
        meta = (chunk_tile, chunk_s0, chunk_lo, chunk_hi, chunk_first, n_chunks_used)
        out = composite_forward_plain(records_t, *meta[:4], n_chunks_used, n_tiles=n_tiles,
                                      tiles_x=tiles_x, chunk=chunk, tile_w=tile_w,
                                      tile_h=tile_h)
        ctx.save_for_backward(records_t, out, inv_perm, pos_of_entry, surv,
                              seg_starts, *meta)
        ctx.static = (n_tiles, tiles_x, chunk, tile_w, tile_h)
        return out

    @staticmethod
    def backward(ctx, g_out):
        (records_t, out, inv_perm, pos_of_entry, surv, seg_starts,
         *meta) = ctx.saved_tensors
        n_tiles, tiles_x, chunk, tile_w, tile_h = ctx.static
        grec_t = composite_backward_plain(
            records_t, *meta[:4], meta[5], out, g_out.contiguous(), n_tiles=n_tiles,
            tiles_x=tiles_x, chunk=chunk, tile_w=tile_w, tile_h=tile_h)
        capacity = pos_of_entry.shape[0]
        u_used = meta[-1]
        n_live = surv.sum()
        e = torch.arange(capacity, dtype=torch.int32, device=grec_t.device)
        keep = (e < n_live) & (pos_of_entry < u_used * chunk)
        pos_safe = torch.where(keep, pos_of_entry, u_used * chunk).long()
        g10 = grec_t[:N_LIVE_FIELDS].t()                   # [cols, 10] view
        csum = blocked_cumsum(g10[pos_safe], 128)
        bidx = torch.clamp(seg_starts - 1, 0, capacity - 1).long()
        bot = torch.where((seg_starts > 0)[:, None], csum[bidx],
                          torch.zeros((), device=csum.device))
        top = torch.cat([bot[1:], csum[-1:]], dim=0)
        grad_rank = top - bot
        grad_n = row_gather(grad_rank, inv_perm)
        grad_n = torch.cat(
            [grad_n, grad_n.new_zeros((grad_n.shape[0], REC_WIDTH - N_LIVE_FIELDS))],
            dim=1)
        return (grad_n,) + (None,) * 16


def render(means3d, scales, quats, opacities, shs, viewmatrix, projmatrix,
           campos, tanfovx, tanfovy, width: int, height: int, bg,
           sh_degree: int = 3, scale_modifier: float = 1.0,
           capacity: int | None = None, chunk: int = 512, valid_mask=None,
           colors_precomp=None, cov3d_precomp=None, means2d_probe=None,
           colors_probe=None, pixel_offset_y: int = 0, full_height: int | None = None,
           tile_w: int | None = None, tile_h: int | None = None) -> dict:
    """Render N Gaussians to an RGB+depth+alpha image, on the device the
    inputs lie on, through the plain versions only.

    pixel_offset_y / full_height: render the `height` rows starting at row
    `pixel_offset_y` of a `full_height`-row image."""
    n = means3d.shape[0]
    if capacity is None:
        capacity = max(4 * n, 2048)
    splats = project_gaussians(
        means3d, scales, quats, opacities, shs, viewmatrix, projmatrix,
        campos, tanfovx, tanfovy, width, full_height or height, sh_degree=sh_degree,
        scale_modifier=scale_modifier, colors_precomp=colors_precomp,
        cov3d_precomp=cov3d_precomp, valid_mask=valid_mask)
    means2d = splats.means2d
    if means2d_probe is not None:
        means2d = means2d + means2d_probe
    colors = splats.colors
    if colors_probe is not None:
        colors = colors + colors_probe
    splats = splats._replace(means2d=means2d, colors=colors)
    return render_from_splats(splats, width, height, bg, capacity=capacity,
                              chunk=chunk, pixel_offset_y=pixel_offset_y, tile_w=tile_w,
                              tile_h=tile_h)


def render_from_splats(splats, width: int, height: int, bg, capacity: int,
                       chunk: int = 512, pixel_offset_y: int = 0,
                       tile_w: int | None = None, tile_h: int | None = None) -> dict:
    """Rasterize already-projected splats (probes applied) into a
    `height`-row image starting at screen row `pixel_offset_y`: binning,
    K3, K1 and K2 work in the band's own coordinates."""
    n = splats.means2d.shape[0]
    dev = splats.means2d.device
    tile_w, tile_h = resolve_tile(tile_w, tile_h)
    tiles_x = cdiv(width, tile_w)
    tiles_y = cdiv(height, tile_h)
    n_tiles = tiles_x * tiles_y
    means2d = splats.means2d
    if pixel_offset_y:
        means2d = means2d - means2d.new_tensor([0.0, float(pixel_offset_y)])

    binned = bin_splats(
        means2d, splats.depths, splats.radii, splats.visible, width, height,
        capacity=capacity, chunk=chunk, conics=splats.conics.detach(),
        opacities=splats.opacities.detach(), tile_w=tile_w, tile_h=tile_h)

    rec_n = torch.cat(
        [means2d, splats.conics, splats.opacities[:, None], splats.colors,
         splats.depths[:, None],
         means2d.new_zeros((n, REC_WIDTH - N_LIVE_FIELDS))], dim=1).float()
    cap_pad = cdiv(capacity, 128) * 128 + chunk
    gid_pad = torch.cat([binned.gid_sorted,
                         torch.zeros((cap_pad - capacity,), dtype=torch.int32, device=dev)])
    tiles_out = GatherComposite.apply(
        rec_n, binned.inv_perm, gid_pad, binned.pos_of_entry,
        binned.surv_counts, binned.seg_starts, binned.chunk_tile,
        binned.chunk_s0, binned.chunk_lo, binned.chunk_hi, binned.chunk_first,
        binned.n_chunks_used, n_tiles, tiles_x, chunk, tile_w, tile_h)

    body = tiles_out[:n_tiles].reshape(tiles_y, tiles_x, ACC_ROWS, tile_h, tile_w)
    full = body.permute(2, 0, 3, 1, 4).reshape(
        ACC_ROWS, tiles_y * tile_h, tiles_x * tile_w)[:, :height, :width]
    rgb_acc = full[0:3]
    depth_acc = full[3]
    t_final = full[4]
    image = rgb_acc + t_final[None] * bg[:, None, None]
    return {
        "image": image,
        "depth": depth_acc,
        "alpha": 1.0 - t_final,
        "t_final": t_final,
        "radii": splats.radii,
        "visibility_filter": splats.visible,
        "n_dropped": binned.n_dropped,
        "n_entries": binned.n_entries,
    }


