"""Front-to-back alpha compositing: kernels K1 (forward) and K2 (backward)
with their plain PyTorch versions.

Port of dreamscene_tpu/ops/composite.py `composite_forward` and
`composite_backward`. Inputs are the field-major sorted record table
records_t [16, cap_pad] (rows mx, my, conic a/b/c, opacity, r, g, b,
depth, 6 zero rows) and the per-chunk metadata of ops/binning.py: chunk u
belongs to tile chunk_tile[u] and holds the entries at columns
chunk_s0[u] + [chunk_lo[u], chunk_hi[u]); a tile's chunks are consecutive.

Forward output: [n_tiles+1, 8, tile_pix] tile accumulators with rows
R, G, B, DEPTH, T, LIVE (live-chunk count), 0, 0; row n_tiles is the
trash tile. Backward output: the per-entry grad table [16, n_chunks*chunk]
(chunk u at columns u*chunk + lane; zero outside live windows, in rows
10-15 and from chunk n_chunks_used on).

Semantics (same as the JAX kernels): alpha = min(0.99, opa*exp(power)),
zero when power > 0 or alpha < 1/255; within each chunk a pixel applies
the prefix of entries that keeps T >= 1e-4; the next chunk resumes from
the T reached. The backward uses dL/dalpha = T c.g - S/(1-alpha) with
S = c_final.g + g_T T_final - prefix(w c.g).

CUDA tensors go to csrc/composite_fwd.cu and csrc/composite_bwd.cu; CPU
tensors go to the plain versions, which process all tiles' k-th chunks
together and each chunk as one [tiles, pixels, lanes] block.

The carry table [n_chunks, 5, tile_pix] (rows R, G, B, DEPTH, T) holds, for
each live chunk, the state of its tile's pixels when the chunk starts; rows
of other chunks are not written. K1 writes it beside the accumulators and
K2 starts every chunk from its row (one CTA per chunk), so a tile's chunks
run side by side: T is K1's own value, and the prefix of w c.g up to the
chunk is g . carry[:4], because the prefix is linear in g.
`composite_forward_carry` returns it and `composite_backward` on CUDA
tensors requires it. The plain versions can
produce and consume the same table (`return_carry`, `carry`), which is how
the CPU tests pin that a chunk restarted from its row gives the sequential
walk's gradients.
"""

from __future__ import annotations

import torch

from dreamscene_tpu_torch import kernels

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


def _check_inputs(records_t, meta, tile_w, tile_h):
    chunk_tile, chunk_s0, chunk_lo, chunk_hi = meta
    kernels.require(records_t, "records_t", torch.float32)
    if records_t.shape[0] != REC_WIDTH:
        raise ValueError(f"records_t must have {REC_WIDTH} rows")
    n_chunks = chunk_tile.shape[0]
    for name, t in (("chunk_tile", chunk_tile), ("chunk_s0", chunk_s0),
                    ("chunk_lo", chunk_lo), ("chunk_hi", chunk_hi)):
        kernels.require(t, name, torch.int32, (n_chunks,))
    tile_pix = tile_w * tile_h
    if tile_pix % 32 or tile_pix > 1024:
        raise ValueError(f"tile of {tile_pix} pixels: the kernels take a "
                         "multiple of 32 up to 1024")


def composite_forward(records_t, chunk_tile, chunk_s0, chunk_lo, chunk_hi,
                      chunk_first, n_chunks_used, n_tiles: int, tiles_x: int,
                      chunk: int = 512, tile_w: int = 32, tile_h: int = 16):
    """Tile accumulators [n_tiles+1, 8, tile_pix] f32."""
    return composite_forward_carry(
        records_t, chunk_tile, chunk_s0, chunk_lo, chunk_hi, chunk_first,
        n_chunks_used, n_tiles, tiles_x, chunk, tile_w, tile_h)[0]


def composite_forward_carry(records_t, chunk_tile, chunk_s0, chunk_lo, chunk_hi,
                            chunk_first, n_chunks_used, n_tiles: int, tiles_x: int,
                            chunk: int = 512, tile_w: int = 32, tile_h: int = 16):
    """(tile accumulators, carry table [n_chunks, 5, tile_pix] f32); the
    table is None for CPU tensors, whose plain backward needs none."""
    if records_t.device.type == "cpu":
        return composite_forward_plain(
            records_t, chunk_tile, chunk_s0, chunk_lo, chunk_hi,
            n_chunks_used, n_tiles, tiles_x, chunk, tile_w, tile_h), None
    args, tensors = prepare_forward(
        records_t, chunk_tile, chunk_s0, chunk_lo, chunk_hi, n_tiles, tiles_x,
        tile_w, tile_h)
    return launch_forward(args, tensors), tensors[-2]


def prepare_forward(records_t, chunk_tile, chunk_s0, chunk_lo, chunk_hi,
                    n_tiles, tiles_x, tile_w, tile_h):
    """Validate and allocate: the K1 launcher's arguments and its buffers
    (inputs, the tile-order scratch its first kernel fills, the carry
    table, then the accumulators)."""
    meta = (chunk_tile, chunk_s0, chunk_lo, chunk_hi)
    _check_inputs(records_t, meta, tile_w, tile_h)
    tile_pix, n_chunks = tile_w * tile_h, chunk_tile.shape[0]
    out = torch.empty((n_tiles + 1, ACC_ROWS, tile_pix), dtype=torch.float32,
                      device=records_t.device)
    carry = torch.empty((n_chunks, CARRY_ROWS, tile_pix), dtype=torch.float32,
                        device=records_t.device)
    order = torch.empty((n_tiles + 1,), dtype=torch.int32, device=records_t.device)
    args = (records_t.data_ptr(), records_t.shape[1], chunk_tile.data_ptr(),
            chunk_s0.data_ptr(), chunk_lo.data_ptr(), chunk_hi.data_ptr(),
            n_chunks, out.data_ptr(), carry.data_ptr(), n_tiles, tiles_x, tile_w, tile_h,
            order.data_ptr(), kernels.stream_ptr(records_t.device))
    return args, (records_t, *meta, order, carry, out)


def tile_order(chunk_tile, chunk_lo, chunk_hi, n_tiles: int):
    """The n_tiles + 1 tiles by live entries, most first, ties in tile
    order: the order in which K1 dispatches its warps (its first kernel
    computes it on the card), so that the longest walks start first and
    spread over the SMs. The same function in plain PyTorch."""
    cost = torch.zeros((n_tiles + 1,), dtype=torch.int32, device=chunk_tile.device)
    cost.index_add_(0, chunk_tile.long(), (chunk_hi - chunk_lo).clamp_min(0))
    return torch.argsort(cost, descending=True, stable=True).to(torch.int32)


def launch_forward(args, tensors):
    """Launch K1 on the current stream; `tensors` keeps the buffers alive
    and ends with the output."""
    kernels.check(kernels.lib().ds_composite_fwd(*args), "composite_fwd")
    kernels.COUNTS["composite_fwd"] += 1
    return tensors[-1]


def composite_backward(records_t, chunk_tile, chunk_s0, chunk_lo, chunk_hi,
                       chunk_first, n_chunks_used, final_accums, grad_accums,
                       n_tiles: int, tiles_x: int, chunk: int = 512,
                       tile_w: int = 32, tile_h: int = 16, carry=None):
    """Per-entry grad table [16, n_chunks*chunk] f32. `carry` is the table
    `composite_forward_carry` returned for these inputs: CUDA tensors need
    it (the plain version walks the chunks in order and needs none)."""
    if records_t.device.type == "cpu":
        return composite_backward_plain(
            records_t, chunk_tile, chunk_s0, chunk_lo, chunk_hi,
            n_chunks_used, final_accums, grad_accums, n_tiles, tiles_x,
            chunk, tile_w, tile_h)
    if carry is None:
        raise ValueError("composite_backward on CUDA tensors needs the carry table that "
                         "composite_forward_carry returned for these inputs")
    return launch_backward(*prepare_backward(
        records_t, chunk_tile, chunk_s0, chunk_lo, chunk_hi, n_chunks_used,
        final_accums, grad_accums, carry, n_tiles, tiles_x, chunk, tile_w, tile_h))


def prepare_backward(records_t, chunk_tile, chunk_s0, chunk_lo, chunk_hi,
                     n_chunks_used, final_accums, grad_accums, carry, n_tiles, tiles_x,
                     chunk, tile_w, tile_h):
    """Validate and allocate: the K2 launcher's arguments and its output."""
    meta = (chunk_tile, chunk_s0, chunk_lo, chunk_hi)
    _check_inputs(records_t, meta, tile_w, tile_h)
    tile_pix, n_chunks = tile_w * tile_h, chunk_tile.shape[0]
    acc_shape = (n_tiles + 1, ACC_ROWS, tile_pix)
    kernels.require(final_accums, "final_accums", torch.float32, acc_shape)
    kernels.require(grad_accums, "grad_accums", torch.float32, acc_shape)
    kernels.require(carry, "carry", torch.float32, (n_chunks, CARRY_ROWS, tile_pix))
    n_used = n_chunks_used.reshape(1).to(torch.int32).contiguous()
    kernels.require(n_used, "n_chunks_used", torch.int32, (1,))
    if not 1 <= chunk <= 1024:
        raise ValueError(f"chunk of {chunk} entries: the K2 kernel takes 1 to 1024")
    grec = torch.empty((REC_WIDTH, n_chunks * chunk), dtype=torch.float32,
                       device=records_t.device)
    args = (records_t.data_ptr(), records_t.shape[1], chunk_tile.data_ptr(),
            chunk_s0.data_ptr(), chunk_lo.data_ptr(), chunk_hi.data_ptr(), n_chunks,
            n_used.data_ptr(), carry.data_ptr(), final_accums.data_ptr(),
            grad_accums.data_ptr(), grec.data_ptr(), n_tiles, tiles_x, tile_w, tile_h,
            chunk, kernels.stream_ptr(records_t.device))
    return args, (records_t, *meta, n_used, carry, final_accums, grad_accums, grec)


def launch_backward(args, tensors):
    """Launch K2 on the current stream; `tensors` keeps the buffers alive
    and ends with the output."""
    kernels.check(kernels.lib().ds_composite_bwd(*args), "composite_bwd")
    kernels.COUNTS["composite_bwd"] += 1
    return tensors[-1]


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

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
    p_incl = torch.cumprod(q, dim=2)
    t_incl = t_carry[:, :, None] * p_incl
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
