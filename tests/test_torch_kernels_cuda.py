"""The hand-written CUDA kernels against their plain PyTorch versions on
the card (the checks chip_smoke.py phases 2 and 2b make, at small sizes).

A CUDA kernel has no CPU or interpret mode, so these tests skip on a host
without a card. On the card:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")


@pytest.mark.parametrize("tile_w,tile_h", [(32, 16), (16, 16)])
def test_kernels_match_plain_versions(card, tile_w, tile_h):
    import chip_smoke as cs
    from dreamscene_tpu_torch.bench import scenes

    st, cam = cs.make_scene(3000, 128, 96, seed=5)
    inp = scenes.binned_inputs(st, cam, tile_w, tile_h)
    errs, _ = cs.check_kernels(f"pytest {tile_w}x{tile_h}", inp, timing=False)
    assert errs["expand_entries"] == 0.0


# K1's first kernel ranks the tiles through a fixed shared-memory window:
# tile counts up to and past the 19,369 whose keys one CTA's shared memory
# could hold, windows of 4,096 keys and their edges, many ties in cost
@pytest.mark.parametrize("n_tiles", [1, 512, 4095, 4096, 19_369, 40_000])
def test_tile_order_kernel_any_tile_count(card, n_tiles):
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.ops import composite as C

    g = torch.Generator().manual_seed(n_tiles)
    n_used, n_free = 3 * n_tiles, 64
    ct = torch.sort(torch.randint(0, n_tiles, (n_used,), generator=g)).values
    ct = torch.cat([ct, torch.full((n_free,), n_tiles)]).int()
    lo = torch.randint(0, 8, (n_used + n_free,), generator=g).int()
    hi = lo + torch.randint(-2, 60, (n_used + n_free,), generator=g).int()
    hi[n_used:] = lo[n_used:]
    ct, lo, hi = (t.cuda() for t in (ct, lo, hi))
    order = torch.empty((n_tiles + 1,), dtype=torch.int32, device="cuda")
    kernels.check(kernels.lib().ds_tile_order(
        ct.data_ptr(), lo.data_ptr(), hi.data_ptr(), ct.shape[0], n_tiles, order.data_ptr(),
        kernels.stream_ptr(ct.device)), "tile_order")
    torch.cuda.synchronize()
    assert torch.equal(order, C.tile_order(ct, lo, hi, n_tiles))


def test_kernels_match_plain_versions_past_one_cta_order(card):
    """K1-K3 at 2560x2560 with 16x16 tiles: 25,600 tiles."""
    import chip_smoke as cs
    from dreamscene_tpu_torch.bench import scenes

    st, cam = cs.make_scene(3000, 2560, 2560, seed=5)
    inp = scenes.binned_inputs(st, cam, 16, 16)
    assert inp["n_tiles"] > cs.ONE_CTA_ORDER_TILES
    errs, _ = cs.check_kernels("pytest 2560x2560 16x16", inp, timing=False)
    assert errs["expand_entries"] == 0.0


# K2 walks one chunk per CTA from K1's carry table: a scene whose splats all
# fall into one or two tiles (one tile holds most chunks, nearly every other
# tile is empty) and one that leaves most tiles empty around a small object,
# at both tile shapes; check_kernels holds K1's carry table and K2 against
# the plain versions and K2 bit-identical across two launches, each from a
# carry table of its own K1 launch
@pytest.mark.parametrize("tile_w,tile_h", [(32, 16), (16, 16)])
@pytest.mark.parametrize("kind,shrink", [("one tile holds most chunks", 0.04),
                                         ("most tiles empty", 0.35)])
def test_composite_bwd_skewed_scenes(card, tile_w, tile_h, kind, shrink):
    import math

    import chip_smoke as cs
    from dreamscene_tpu_torch.bench import scenes

    st, cam = cs.make_scene(4000, 192, 128, seed=9)
    st.params["xyz"].mul_(shrink)
    st.params["scaling"].add_(math.log(shrink))
    inp = scenes.binned_inputs(st, cam, tile_w, tile_h, chunk=128)
    stats = scenes.tile_stats(inp)
    if shrink < 0.1:
        assert stats["entries_share_of_busiest_1pct_tiles"] > 0.3, stats
        assert stats["chunks_per_tile_max"] >= 4, stats
    assert stats["empty_tile_share"] > 0.5, stats
    cs.check_kernels(f"pytest {kind} {tile_w}x{tile_h}", inp, timing=False)


# K1 runs one warp per 32 pixels: its accumulators and live carry rows are
# bit-identical across two launches (no atomics, no order that depends on
# scheduling), on the skewed scenes above, at both tile shapes
@pytest.mark.parametrize("tile_w,tile_h", [(32, 16), (16, 16)])
@pytest.mark.parametrize("shrink", [0.04, 0.35])
def test_composite_fwd_bit_identical_across_launches(card, tile_w, tile_h, shrink):
    import math

    import chip_smoke as cs
    from dreamscene_tpu_torch.bench import scenes
    from dreamscene_tpu_torch.ops import composite as C

    st, cam = cs.make_scene(4000, 192, 128, seed=9)
    st.params["xyz"].mul_(shrink)
    st.params["scaling"].add_(math.log(shrink))
    inp = scenes.binned_inputs(st, cam, tile_w, tile_h, chunk=128)
    rt, meta = inp["records_t"], inp["meta"]
    geo = dict(n_tiles=inp["n_tiles"], tiles_x=inp["tiles_x"], chunk=inp["chunk"],
               tile_w=tile_w, tile_h=tile_h)
    live_u = torch.nonzero((meta[3] > meta[2])[:int(meta[5])]).flatten()
    assert live_u.numel() > 0
    out_1, carry_1 = C.composite_forward_carry(rt, *meta, **geo)
    out_1, carry_1 = out_1.clone(), carry_1[live_u].clone()
    out_2, carry_2 = C.composite_forward_carry(rt, *meta, **geo)
    torch.cuda.synchronize()
    assert torch.equal(out_1, out_2)
    assert torch.equal(carry_1, carry_2[live_u])


def test_kernels_match_plain_versions_one_warp_tiles(card):
    """8 x 4 tiles: one warp is a whole tile (K1), one CTA of one warp per
    chunk (K2)."""
    import chip_smoke as cs
    from dreamscene_tpu_torch.bench import scenes

    st, cam = cs.make_scene(3000, 128, 96, seed=5)
    inp = scenes.binned_inputs(st, cam, 8, 4, chunk=128)
    errs, _ = cs.check_kernels("pytest 8x4", inp, timing=False)
    assert errs["expand_entries"] == 0.0


def test_expand_one_kernel_per_call(card):
    """A CUDA expand_entries call issues exactly one device kernel (the
    window ends, the clamp and n_entries are read inside K3)."""
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.bench import scenes
    from dreamscene_tpu_torch.ops import expand as E

    st, cam = cs.make_scene(3000, 128, 96, seed=5)
    kw = scenes.binned_inputs(st, cam, 32, 16)["ex"]["kwargs"]
    E.expand_entries(**kw)
    torch.cuda.synchronize()
    kernels.reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            E.expand_entries(**kw)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 3 and all("expand_kernel" in n for n in names), names
    assert kernels.COUNTS["expand_entries"] == 3


@pytest.mark.parametrize("cull", [True, False])
def test_expand_owner_range_overflows_shared_buffer(card, cull):
    """Blocks whose owner range exceeds the staged rows (long runs of empty
    splats between a few huge ones, and the tail) search in device memory
    and stay bit-equal to the plain version."""
    import numpy as np

    from dreamscene_tpu_torch.ops import expand as E

    rng = np.random.RandomState(3 + cull)
    n, tiles_x, n_tiles = 12_000, 16, 256
    count = rng.randint(1, 6, n).astype(np.int32)
    count[2000:5000] = 0                      # 3000 empty splats inside one block
    count[[100, 1500, 6000]] = 3000           # a few huge splats
    count[9000:] = 0                          # the tail
    offsets = (np.cumsum(count) - count).astype(np.int32)
    capacity = int(count.sum()) + 3000        # slots past the last entry too
    ub = np.searchsorted(offsets, np.minimum(np.arange(0, capacity, E.SLOTS), capacity),
                         side="right")
    last = np.minimum(np.arange(0, capacity, E.SLOTS) + E.SLOTS, capacity) - 1
    widest = int((np.searchsorted(offsets, last, side="right") - ub).max())
    assert widest > 1024, widest              # csrc/expand.cu stages 1024 rows
    x0 = rng.randint(0, tiles_x, n)
    nx = np.minimum(rng.randint(1, 4, n), tiles_x - x0)
    basenx = ((rng.randint(0, 8, n) * tiles_x + x0) * 256 + nx).astype(np.int32)
    perm = rng.permutation(n).astype(np.int32)
    caps = tuple(rng.randint(0, 1 << 24, n).astype(np.int32) for _ in range(3)) if cull else None
    kw = dict(capacity=capacity, n=n, n_tiles=n_tiles, tiles_x=tiles_x, shift=14,
              rank_drop=0, tile_w=32, tile_h=16)

    def args(dev):
        t = lambda a: torch.from_numpy(a).to(dev)
        return dict(offsets=t(offsets), basenx=t(basenx), perm=t(perm),
                    n_entries=torch.tensor(int(count.sum()), dtype=torch.int32, device=dev),
                    caps=None if caps is None else tuple(t(c) for c in caps), **kw)

    key_k, gid_k = E.expand_entries(**args("cuda"))
    key_p, gid_p = E.expand_entries_plain(**args("cuda"))
    torch.cuda.synchronize()
    assert torch.equal(key_k, key_p) and torch.equal(gid_k, gid_p)


@pytest.mark.parametrize("block", [1024, 384, 128])
@pytest.mark.parametrize("cull", [True, False])
def test_expand_any_multiple_of_128_slots(card, block, cull):
    """K3 with window blocks of any multiple of 128 slots (DS_EXPAND_BLOCK;
    384 and 128 run 128-slot CUDA blocks) is bit-equal to the plain version,
    including the slots past the last entry, whose owners the window
    decides."""
    import numpy as np

    from dreamscene_tpu_torch.ops import expand as E

    rng = np.random.RandomState(block + cull)
    n, tiles_x, n_tiles = 6000, 16, 256
    count = rng.randint(0, 6, n).astype(np.int32)
    count[4500:] = 0
    offsets = (np.cumsum(count) - count).astype(np.int32)
    capacity = int(count.sum()) + 2 * block + 77
    x0 = rng.randint(0, tiles_x, n)
    nx = np.minimum(rng.randint(1, 4, n), tiles_x - x0)
    basenx = ((rng.randint(0, 8, n) * tiles_x + x0) * 256 + nx).astype(np.int32)
    perm = rng.permutation(n).astype(np.int32)
    caps = tuple(rng.randint(0, 1 << 24, n).astype(np.int32) for _ in range(3)) if cull else None
    t = lambda a: torch.from_numpy(a).cuda()
    kw = dict(offsets=t(offsets), basenx=t(basenx), perm=t(perm),
              n_entries=torch.tensor(int(count.sum()), dtype=torch.int32, device="cuda"),
              caps=None if caps is None else tuple(t(c) for c in caps), capacity=capacity,
              n=n, n_tiles=n_tiles, tiles_x=tiles_x, shift=13, rank_drop=0, tile_w=32,
              tile_h=16, block=block)
    key_k, gid_k = E.expand_entries(**kw)
    key_p, gid_p = E.expand_entries_plain(**kw)
    torch.cuda.synchronize()
    assert torch.equal(key_k, key_p) and torch.equal(gid_k, gid_p)


def test_scene_step_card_matches_cpu(card):
    """A small scene step (objects, env, floor) on the card against the
    CPU: chip_smoke.py's phase 8."""
    import chip_smoke as cs

    cs.small_scene_parity()


# every head-dim bucket of the tensor-core kernels (bfloat16: 64, 128, 256,
# 512, and d = 48 zero-padded to 64) and of the CUDA-core variant (float32
# at the same buckets; bfloat16 with d % 16 != 0); check_flash also runs
# the forward on strided views of [b, n, h*d] projections
@pytest.mark.parametrize("shape,dtype", [((2, 3, 1024, 64), torch.bfloat16),
                                         ((1, 1, 1024, 512), torch.bfloat16),
                                         ((1, 2, 512, 128), torch.bfloat16),
                                         ((1, 1, 512, 256), torch.bfloat16),
                                         ((1, 2, 256, 48), torch.bfloat16),
                                         ((1, 2, 256, 40), torch.bfloat16),
                                         ((1, 2, 256, 40), torch.float32),
                                         ((1, 1, 384, 256), torch.float32),
                                         ((1, 2, 256, 64), torch.float32),
                                         ((1, 2, 256, 48), torch.float32),
                                         ((1, 1, 256, 128), torch.float32),
                                         ((1, 1, 256, 512), torch.float32)])
def test_flash_kernels_match_plain_versions(card, shape, dtype):
    import chip_smoke as cs
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.ops import flash_attention as fa

    kernels.reset_counts()
    row = cs.check_flash(f"pytest {shape}", shape, dtype, timing=False)
    assert set(row["errs"]) == {"flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"}
    tc = int(fa.kernel_variant(dtype, shape[3]) == "tc")
    assert kernels.COUNTS["flash_fwd"] > 0 and kernels.COUNTS["flash_bwd_dkv"] > 0
    assert kernels.COUNTS["flash_fwd.tc"] == tc * kernels.COUNTS["flash_fwd"]
    assert kernels.COUNTS["flash_bwd_dkv.tc"] == tc * kernels.COUNTS["flash_bwd_dkv"]
    assert kernels.COUNTS["flash_bwd_dq"] > 0
    assert kernels.COUNTS["flash_bwd_dq.tc"] == tc * kernels.COUNTS["flash_bwd_dq"]
    assert row["variant"]["flash_bwd_dq"].startswith("tc" if tc else "scalar")


def test_flash_fwd_strided_views(card):
    """The forward on the attention module's transposed views equals the
    forward on contiguous copies, bit for bit, and o's [b, n, h*d] reshape
    is a view; a view without unit stride in d raises."""
    from dreamscene_tpu_torch.ops import flash_attention as fa

    b, h, n, d = 2, 5, 1024, 64
    gen = torch.Generator(device="cuda").manual_seed(3)
    proj = [torch.randn((b, n, h * d), device="cuda", generator=gen).bfloat16()
            for _ in range(3)]
    views = [x.reshape(b, n, h, d).transpose(1, 2) for x in proj]
    o_v, l_v, m_v = fa.flash_fwd(*views, d**-0.5)
    o_c, l_c, m_c = fa.flash_fwd(*(x.contiguous() for x in views), d**-0.5)
    torch.cuda.synchronize()
    assert torch.equal(o_v, o_c) and torch.equal(l_v, l_c) and torch.equal(m_v, m_c)
    assert o_v.transpose(1, 2).reshape(b, n, h * d).data_ptr() == o_v.data_ptr()
    bad = views[0].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError):
        fa.flash_fwd(bad, views[1], views[2], d**-0.5)
