"""Operations and bytes of the rasterizer's parts for one view.

K1 (composite forward) and K2 (composite backward) are counted per evaluated
(entry, pixel) pair, from the kernels' inner loops: K1 evaluates alpha
(~16 operations with the exp) and accumulates (~11); K2 replays alpha and
forms the 10 per-entry terms (~55) plus its share of the warp sums (~10).
Bytes count each input byte read once and each output byte written once,
over what the view needs: the live entries' records (10 float32 fields),
the live chunks' metadata (4 int32) and carry rows (5 x tile pixels
float32), the tile accumulators (8 rows x tile pixels float32, one trash
tile included); K2 reads the accumulators and their gradients and writes
the live entries' 10 gradient fields.

Projection and SH are counted per splat from the formulas of
`reference/projection.py` and `reference/sh.py`; their backward at twice
the forward.

`view_counts` bins a view with the reference (`reference/raster.py`) and
walks its compositing to count the pairs: in each chunk a pixel evaluates
its live entries up to and including the one that stops it.
"""

from __future__ import annotations

import torch

K1_OPS_PER_PAIR = 27
K2_OPS_PER_PAIR = 65
RECORD_FIELDS = 10
META_INTS = 4
CARRY_ROWS = 5
ACC_ROWS = 8
# projection of one splat: quaternion to rotation (~30), R S and the 3D
# covariance (~45), view and clip transforms (2 x 28), the Jacobian and the
# 2D covariance (~60), the conic and the radius (~15)
PROJECT_OPS = 206


def sh_ops(degree: int) -> int:
    """SH colour of one splat: direction (~12), the basis (~3 per
    coefficient) and the 3-channel contraction (2 per coefficient and
    channel), plus the offset and clamp (6)."""
    k = (degree + 1) ** 2
    return 12 + 3 * k + 6 * k + 6


def k1(live: int, pairs: int, live_chunks: int, n_tiles: int, tile_pix: int) -> dict:
    acc = (n_tiles + 1) * ACC_ROWS * tile_pix * 4
    nbytes = (live * RECORD_FIELDS * 4 + live_chunks * META_INTS * 4 + acc
              + live_chunks * CARRY_ROWS * tile_pix * 4)
    return {"ops": pairs * K1_OPS_PER_PAIR, "bytes": nbytes}


def k2(live: int, pairs: int, live_chunks: int, n_tiles: int, tile_pix: int) -> dict:
    acc = (n_tiles + 1) * ACC_ROWS * tile_pix * 4
    nbytes = (live * RECORD_FIELDS * 4 + live_chunks * META_INTS * 4 + 2 * acc
              + live_chunks * CARRY_ROWS * tile_pix * 4 + live * RECORD_FIELDS * 4)
    return {"ops": pairs * K2_OPS_PER_PAIR, "bytes": nbytes}


def splat_ops(n_visible: int, sh_degree: int) -> dict:
    """Projection and SH over the visible splats, forward and backward."""
    fwd = n_visible * (PROJECT_OPS + sh_ops(sh_degree))
    return {"ops": 3 * fwd}


@torch.no_grad()
def view_counts(splats, width: int, height: int, capacity: int, chunk: int,
                tile_w: int, tile_h: int) -> dict:
    """Live entries, evaluated pairs, live chunks, tiles and visible splats
    of one projected view, as the reference bins and composites it."""
    from benchmark.reference import raster as R

    b = R.bin_splats(splats.means2d, splats.depths, splats.radii, splats.visible, width,
                     height, capacity=capacity, chunk=chunk, conics=splats.conics,
                     opacities=splats.opacities, tile_w=tile_w, tile_h=tile_h)
    tiles_x, tiles_y = R.cdiv(width, tile_w), R.cdiv(height, tile_h)
    n_tiles = tiles_x * tiles_y
    n = splats.means2d.shape[0]
    rec_n = torch.cat([splats.means2d, splats.conics, splats.opacities[:, None],
                       splats.colors, splats.depths[:, None],
                       splats.means2d.new_zeros((n, R.REC_WIDTH - R.N_LIVE_FIELDS))],
                      dim=1).float()
    cap_pad = R.cdiv(capacity, 128) * 128 + chunk
    gid_pad = torch.cat([b.gid_sorted, torch.zeros((cap_pad - capacity,), dtype=torch.int32,
                                                   device=rec_n.device)])
    rt = R.row_gather(rec_n, gid_pad).t().contiguous()
    ct, s0, lo, hi, n_used = b.chunk_tile, b.chunk_s0, b.chunk_lo, b.chunk_hi, b.n_chunks_used
    live_mask = (hi > lo)[:int(n_used)]
    live = int((hi - lo).clamp_min(0).sum())
    tile_pix = tile_w * tile_h
    t_state = torch.ones((n_tiles + 1, tile_pix), device=rt.device)
    lanes = torch.arange(chunk, device=rt.device)
    pairs = 0
    for us in R._slots(ct, n_used):
        for grp in R._groups(us, tile_pix, chunk):
            grp = grp[hi[grp] > lo[grp]]
            if grp.numel() == 0:
                continue
            tiles = ct[grp].long()
            v = R._chunk_block(rt, grp, ct, s0, lo, hi, t_state[tiles], tiles_x, chunk,
                               tile_w, tile_h)
            window = (lanes >= lo[grp, None]) & (lanes < hi[grp, None])
            pairs += int((v["applied"] & window[:, None, :]).sum())
            pairs += int((~v["applied"][:, :, -1]).sum())
            t_state[tiles] = v["t_new"]
    return {"live": live, "pairs": pairs, "live_chunks": int(live_mask.sum()),
            "n_tiles": n_tiles, "tile_pix": tile_pix, "n_entries": int(b.n_entries),
            "n_dropped": int(b.n_dropped), "visible": int(splats.visible.sum())}
