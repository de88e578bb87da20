"""Binning parity: the port's `bin_splats` and the plain version of kernel
K3 against the JAX package on the same numpy inputs.

Tolerance: every integer output is bit-equal (keys, gids, chunk metadata,
pos_of_entry, n_entries, n_dropped), at 16x16 and 32x16 tiles, with the
capsule cull on and off and on the coarse-key (rank_drop) path.
"""

import bisect
import ctypes

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dreamscene_tpu.ops import binning as jbin
from dreamscene_tpu.ops.expand import expand_entries as j_expand
from dreamscene_tpu_torch.ops import binning as tbin
from dreamscene_tpu_torch.ops import expand as texp
from dreamscene_tpu_torch.ops.expand import expand_entries as t_expand

# One intra-op thread: the suite runs several worker processes at once, and
# one OpenMP team of all cores per worker makes these small tensors wait on
# each other (the six heaviest files of the port took 205 s on 8 cores with
# 6 workers, 66 s with one thread each).
torch.set_num_threads(1)

INT_FIELDS = ["rank_sorted", "gid_sorted", "n_chunks_used", "chunk_tile",
              "chunk_s0", "chunk_lo", "chunk_hi", "chunk_first", "n_entries",
              "n_dropped", "perm", "inv_perm", "surv_counts", "seg_starts",
              "pos_of_entry"]


def projected(n, width, height, seed):
    """Random screen-space splats in numpy: means (some off screen),
    depths with ties, radii, conics of random ellipses, opacities."""
    rng = np.random.RandomState(seed)
    means = np.stack([rng.uniform(-20, width + 20, n),
                      rng.uniform(-20, height + 20, n)], 1).astype(np.float32)
    depths = rng.uniform(0.5, 5.0, n).astype(np.float32)
    depths[: n // 10] = depths[n // 10: 2 * (n // 10)]          # ties
    sx = rng.uniform(0.5, 12.0, n)
    sy = rng.uniform(0.5, 12.0, n)
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    cxx = c * c * sx * sx + s * s * sy * sy + 0.3
    cyy = s * s * sx * sx + c * c * sy * sy + 0.3
    cxy = c * s * (sx * sx - sy * sy)
    det = cxx * cyy - cxy * cxy
    conics = np.stack([cyy / det, -cxy / det, cxx / det], 1).astype(np.float32)
    lam = 0.5 * (cxx + cyy) + np.sqrt(np.maximum(0.1, 0.25 * (cxx + cyy) ** 2 - det))
    radii = np.ceil(3.0 * np.sqrt(lam)).astype(np.int32)
    visible = rng.rand(n) > 0.1
    radii = np.where(visible, radii, 0).astype(np.int32)
    opac = rng.uniform(0.001, 1.0, n).astype(np.float32)
    return means, depths, radii, radii > 0, conics, opac


CASES = [
    # (tile_w, tile_h, cull, rank_drop_override, capacity)
    (16, 16, True, None, 6000),
    (32, 16, True, None, 6000),
    (32, 16, False, None, 6000),
    (32, 16, True, 3, 6000),
    (16, 16, True, None, 700),      # overflow: entries dropped
]


@pytest.mark.parametrize("tw,th,cull,rdrop,cap", CASES)
def test_bin_splats_bit_equal(tw, th, cull, rdrop, cap):
    width, height, n = 96, 64, 500
    means, depths, radii, vis, conics, opac = projected(n, width, height, seed=tw + th + cap)
    kw = dict(width=width, height=height, capacity=cap, chunk=128,
              rank_drop_override=rdrop, tile_w=tw, tile_h=th)
    jb = jbin.bin_splats(
        jnp.asarray(means), jnp.asarray(depths), jnp.asarray(radii), jnp.asarray(vis),
        conics=jnp.asarray(conics) if cull else None,
        opacities=jnp.asarray(opac) if cull else None, interpret=True, **kw)
    tb = tbin.bin_splats(
        torch.from_numpy(means), torch.from_numpy(depths), torch.from_numpy(radii),
        torch.from_numpy(vis), conics=torch.from_numpy(conics) if cull else None,
        opacities=torch.from_numpy(opac) if cull else None, **kw)
    if cap == 700:
        assert int(jb.n_dropped) > 0
    live = int((tb.chunk_hi - tb.chunk_lo).sum())
    if cull:   # the capsule cull re-keys some entries to the trash tile
        assert live < int(tb.n_entries)
    for f in INT_FIELDS:
        a = np.asarray(getattr(jb, f))
        b = getattr(tb, f).numpy()
        assert a.dtype == np.int32 and b.dtype == np.int32, f
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("cull", [True, False])
def test_expand_plain_matches_jax_kernel(cull):
    """K3's plain version against the Pallas kernel in interpret mode, on
    rank-order inputs that include entry-less splats at the tail (whose
    slots depend on the kernel's window limit)."""
    rng = np.random.RandomState(11 + cull)
    n, tiles_x, n_tiles = 900, 6, 24
    count = rng.randint(0, 5, n).astype(np.int32)
    count[700:] = 0
    offsets = (np.cumsum(count) - count).astype(np.int32)
    x0 = rng.randint(0, tiles_x, n)
    nx = np.minimum(rng.randint(1, 3, n), tiles_x - x0)
    basenx = ((rng.randint(0, 4, n) * tiles_x + x0) * 256 + nx).astype(np.int32)
    perm = rng.permutation(n).astype(np.int32)
    capacity = 2500
    n_entries = min(int(count.sum()), capacity)
    caps = None
    if cull:
        caps = tuple(rng.randint(0, 1 << 24, n).astype(np.int32) for _ in range(3))
    kw = dict(capacity=capacity, n=n, n_tiles=n_tiles, tiles_x=tiles_x,
              shift=10, rank_drop=0, tile_w=32, tile_h=16)
    jk, jg = j_expand(
        jnp.asarray(offsets), jnp.asarray(basenx), jnp.asarray(perm),
        jnp.asarray(n_entries, jnp.int32),
        caps=None if caps is None else tuple(jnp.asarray(c) for c in caps),
        interpret=True, block=2048, **kw)
    tk, tg = t_expand(
        torch.from_numpy(offsets), torch.from_numpy(basenx), torch.from_numpy(perm),
        torch.tensor(n_entries, dtype=torch.int32),
        caps=None if caps is None else tuple(torch.from_numpy(c) for c in caps),
        block=2048, **kw)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


def test_max_chunks_matches():
    for cap, nt, ch in [(240000, 512, 512), (6000, 24, 128), (1, 1, 128)]:
        assert tbin.max_chunks(cap, nt, ch) == jbin.max_chunks(cap, nt, ch)
    assert tbin.max_chunks(240000, 512, 512) == 1108


# ---------------------------------------------------------------------------
# K3's per-block bookkeeping (csrc/expand.cu), mirrored line by line in Python
# with C's integer semantics; the kernel itself runs only on the card
# (tests/test_torch_kernels_cuda.py).

def c_div(a: int, b: int) -> int:
    """C's `/` on ints: truncates toward zero (Python's // floors)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def kernel_window_end(offsets, e0: int, block: int) -> int:
    """The window end the CUDA block holding slot e0 derives: two
    upper-bound searches over the unclamped offsets, then
    w0a + 128 * clamp(ceil((ws_end - w0a) / 128), 1, (block + 256) / 128)."""
    bstart = c_div(e0, block) * block
    ws0 = max(bisect.bisect_right(offsets, bstart) - 1, 0)
    w0a = c_div(ws0, 128) * 128
    ws_end = bisect.bisect_right(offsets, bstart + block - 1)
    assert ws_end - w0a >= 0          # so that the truncating division rounds up
    wlive = min(max(c_div(ws_end - w0a + 127, 128), 1), c_div(block + 256, 128))
    return w0a + 128 * wlive


def kernel_owners(offsets, capacity: int, e0: int):
    """The owner count (upper bound over the clamped offsets) of every slot of
    the CUDA block starting at e0, as the kernel finds it: the range
    [r0, r1] of the block's first and last slot, then a search inside it."""
    offs_c = [min(o, capacity) for o in offsets]
    last = min(e0 + texp.SLOTS, capacity) - 1
    r0 = bisect.bisect_right(offs_c, e0)
    r1 = bisect.bisect_right(offs_c, last)
    rows = offs_c[r0:r1]
    return [r0 + bisect.bisect_right(rows, e) for e in range(e0, last + 1)], r1 - r0


def _offsets(kind: str):
    """(offsets, capacity) of one edge case; exclusive offsets are sorted."""
    rng = np.random.RandomState(len(kind))
    if kind == "random, tail of empty splats":
        count = rng.randint(0, 9, 3000)
        count[2400:] = 0
        return np.cumsum(count) - count, 9000
    if kind == "block starts before the first offset":
        return 3000 + np.arange(0, 4000, 3), 6500
    if kind == "a block inside one splat's run":
        count = rng.randint(1, 4, 500)
        count[100] = 5000
        return np.cumsum(count) - count, 7000
    if kind == "ws_end - w0a a multiple of 128":
        return np.arange(0, 8 * 1000, 8), 8000        # 256 splats per 2048 slots
    if kind == "capacity not a multiple of 2048":
        count = rng.randint(0, 6, 2000)
        return np.cumsum(count) - count, 5000
    if kind == "offsets past capacity":
        count = rng.randint(2, 7, 2000)
        return np.cumsum(count) - count, 3000
    raise KeyError(kind)


OFFSET_CASES = ["random, tail of empty splats", "block starts before the first offset",
                "a block inside one splat's run", "ws_end - w0a a multiple of 128",
                "capacity not a multiple of 2048", "offsets past capacity"]


@pytest.mark.parametrize("kind", OFFSET_CASES)
def test_kernel_window_end_formula_matches_window_ends(kind):
    offsets, capacity = _offsets(kind)
    offsets = [int(o) for o in offsets]
    block = texp.BLOCK
    ref = texp._window_ends(torch.tensor(offsets, dtype=torch.int32), capacity, block)
    got = [kernel_window_end(offsets, e0, block) for e0 in range(0, capacity, texp.SLOTS)]
    want = [int(ref[e0 // block]) for e0 in range(0, capacity, texp.SLOTS)]
    assert got == want
    if kind == "block starts before the first offset":
        assert bisect.bisect_right(offsets, 0) == 0
    if kind == "ws_end - w0a a multiple of 128":
        assert (bisect.bisect_right(offsets, block - 1) - 0) % 128 == 0
    if kind == "capacity not a multiple of 2048":
        assert capacity % block != 0


@pytest.mark.parametrize("kind", OFFSET_CASES)
def test_kernel_owner_search_matches_searchsorted(kind):
    """Per CUDA block, r0 + a search inside the block's owner range gives
    every slot's upper bound over the clamped offsets (what the plain
    version and the JAX kernel use); some cases have ranges wider than the
    1024 rows a block stages."""
    offsets, capacity = _offsets(kind)
    offs_c = torch.clamp_max(torch.tensor(offsets, dtype=torch.int32), capacity)
    want = torch.searchsorted(offs_c, torch.arange(capacity, dtype=torch.int32),
                              right=True).tolist()
    got, widest = [], 0
    for e0 in range(0, capacity, texp.SLOTS):
        owners, width = kernel_owners([int(o) for o in offsets], capacity, e0)
        got += owners
        widest = max(widest, width)
    assert got == want
    if kind == "random, tail of empty splats":
        assert widest > 0


def test_expand_geometry_struct():
    """The ctypes struct K3 takes has csrc/expand.cu's layout (10 ints,
    then 5 floats, no padding) and is built once per geometry; a window
    block that no whole number of CUDA blocks fills is refused."""
    assert ctypes.sizeof(texp.ExpandGeo) == 60
    names = [f[0] for f in texp.ExpandGeo._fields_]
    assert names[:10] == ["capacity", "n", "n_tiles", "tiles_x", "shift", "rank_drop",
                          "block", "use_cull", "tile_w", "tile_h"]
    assert texp.ExpandGeo.cxo.offset == 40
    g = texp.expand_geometry(6000, 500, 24, 6, 10, 0, 2048, True, 32, 16)
    assert g is texp.expand_geometry(6000, 500, 24, 6, 10, 0, 2048, True, 32, 16)
    c = texp._cull_consts(32, 16, 6)
    assert (g.capacity, g.block, g.use_cull, g.tile_w) == (6000, 2048, 1, 32)
    assert np.float32(g.inv_tiles_x) == np.float32(c["inv_tiles_x"])
    assert np.float32(g.hwy) == np.float32(c["hwy"])
    with pytest.raises(ValueError):
        texp.expand_geometry(6000, 500, 24, 6, 10, 0, 1000, True, 32, 16)
