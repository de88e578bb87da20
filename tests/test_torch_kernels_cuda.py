"""The hand-written CUDA kernels against their plain PyTorch versions on
the card (the checks chip_smoke.py phases 2 and 2b make, at small sizes).

A CUDA kernel has no CPU or interpret mode, so these tests skip on a host
without a card. On the card:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda
"""

import math

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


def _bf16_ulp(x: float) -> float:
    """One bfloat16 ulp at magnitude x."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0**-126))) - 7)


def _attention_ref(q, k, v, scale):
    """softmax(scale q k^T) v in float32, one batch row at a time."""
    return torch.cat([torch.softmax(q[i:i + 1].float() @ k[i:i + 1].float().transpose(-1, -2)
                                    * scale, -1) @ v[i:i + 1].float()
                      for i in range(q.shape[0])])


# SD 2.1's self-attention at the 64x64 latent (12 = 3 prompts x 4 cameras,
# 5 heads of 64) and the VAE mid block's single head of 512 at 64x64
@pytest.mark.parametrize("kind", ["unet", "vae"])
def test_attention_block_through_the_gate(card, kind, monkeypatch):
    """The block's core on the card through the gate launches K4 once and
    equals the K4 plain version on the same operands within one bf16 ulp
    at the output's scale (the CPU tests' bound against the JAX kernel;
    the kernels tile otherwise, so the per-element bound of equal blocking
    does not apply). Against a float32 softmax of the same bf16 operands,
    it is no further off than the module's plain branch, which rounds the
    scores to bf16 first."""
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.guidance import sd_modules as sdm
    from dreamscene_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(17)
    with torch.device("cuda"):
        if kind == "unet":
            b, h, n, d = 12, 5, 4096, 64
            mod = sdm.init_random_(sdm.Attention(h * d, h, d, torch.bfloat16), gen)
            x = torch.randn((b, n, h * d), generator=gen, device="cuda")
        else:
            b, h, n, d = 4, 1, 4096, 512
            mod = sdm.init_random_(sdm.VAEAttention(d, 32, torch.bfloat16), gen)
            x = torch.randn((b, d, 64, 64), generator=gen, device="cuda")
    # unit-variance operands, so the scores spread as N(0, 1), drawn once
    proj, core = {}, []

    def operand(name):
        def hook(_m, _inp, out):
            if name not in proj:
                proj[name] = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
            return proj[name]
        return hook

    for name in ("to_q", "to_k", "to_v"):
        getattr(mod, name).register_forward_hook(operand(name))
    mod.to_out[0].register_forward_pre_hook(lambda _m, args: core.append(args[0].float()))

    kernels.reset_counts()
    with torch.no_grad():
        mod(x)
        torch.cuda.synchronize()
        assert kernels.COUNTS["flash_fwd"] == 1 and kernels.COUNTS["flash_fwd.tc"] == 1
        with monkeypatch.context() as mp:
            mp.setattr(fa, "flash_attention",
                       lambda q, k, v, scale: fa.flash_attention_fwd_plain(q, k, v, scale)[0])
            mod(x)
        with monkeypatch.context() as mp:
            mp.setattr(fa, "use_flash_attention", lambda *_: False)
            mod(x)
        assert kernels.COUNTS["flash_fwd"] == 1
        q, k, v = (proj[t].reshape(b, n, h, d).transpose(1, 2) for t in ("to_q", "to_k", "to_v"))
        ref = _attention_ref(q, k, v, d**-0.5).transpose(1, 2).reshape(b, n, h * d)
    k4, plain_version, plain_branch = core
    assert (k4 - plain_version).abs().max() <= _bf16_ulp(plain_version.abs().max().item())
    e_k4, e_branch = k4 - ref, plain_branch - ref
    assert e_k4.abs().max() <= e_branch.abs().max(), (e_k4.abs().max(), e_branch.abs().max())
    assert e_k4.norm() <= e_branch.norm(), (e_k4.norm(), e_branch.norm())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_launches_at_every_admitted_self_attention(card, dtype):
    """One pass of the tiny UNet at a 32x32 latent launches the K4 forward
    at its three self-attentions of 1024 tokens (down_blocks.0's block,
    up_blocks.1's two); the 256-token level and the cross-attentions take
    the plain path. The VAE encoder's mid block at 64x64 launches one
    forward, and its backward one dK/dV and one dQ. bfloat16 takes the
    tensor-core variant, float32 the CUDA-core one."""
    import dataclasses

    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.guidance import sd_modules as sdm

    gen = torch.Generator(device="cuda").manual_seed(5)
    with torch.device("cuda"):
        unet = sdm.init_random_(sdm.UNet2DCondition(
            dataclasses.replace(sdm.tiny_unet_config(), dtype=dtype)), gen)
        enc = sdm.init_random_(sdm.VAEEncoder(
            dataclasses.replace(sdm.tiny_vae_config(), dtype=dtype)), gen)
    lat = torch.randn((2, 4, 32, 32), generator=gen, device="cuda")
    ctx = torch.randn((2, 4, 32), generator=gen, device="cuda")
    kernels.reset_counts()
    with torch.no_grad():
        unet(lat, torch.full((2,), 500, device="cuda"), ctx)
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16)
    assert kernels.COUNTS["flash_fwd"] == 3 and kernels.COUNTS["flash_fwd.tc"] == 3 * tc
    img = torch.rand((1, 3, 128, 128), generator=gen, device="cuda", requires_grad=True)
    enc(img).sum().backward()
    torch.cuda.synchronize()
    assert img.grad is not None and torch.isfinite(img.grad).all()
    assert kernels.COUNTS["flash_fwd"] == 4 and kernels.COUNTS["flash_fwd.tc"] == 4 * tc
    assert kernels.COUNTS["flash_bwd_dkv"] == 1 and kernels.COUNTS["flash_bwd_dq"] == 1


def test_norm_kernels_match_plain_versions_at_the_ladder_shapes(card):
    """Every group norm (with SiLU, or token-major before an attention
    block) and layer norm of an SD 2.1-width UNet pass at batch 12, in NCHW
    and channels-last, against the plain version: float32 outputs (the
    conv_norm_out) within 1e-5 (1 + |plain|), bf16 outputs within one bf16
    ulp beyond that, the two being one rounding of float32 values that differ
    only in the order of the moments' sums (chip_smoke.norm_error, phase 2c)."""
    import chip_smoke as cs

    errs, _, _ = cs.check_norms(timing=False)
    assert set(errs) == set(cs.NORMS) and all(e <= 1.0 for e in errs.values()), errs


# the tiny float32 stacks' shapes, a float32 input before a bf16 layer, and
# the kernels' other branches: 63 tokens (no whole 16-byte vectors), slabs
# too large for shared memory (the VAE's 256^2 and 512^2 levels), which read
# x a second time for the output
@pytest.mark.parametrize("shape,groups,dtype,out", [
    ((2, 32, 32, 32), 8, torch.float32, torch.float32),
    ((2, 96, 32, 32), 8, torch.float32, torch.float32),
    ((2, 128, 16, 16), 8, torch.float32, torch.float32),
    ((1, 32, 64, 64), 8, torch.float32, torch.bfloat16),
    ((2, 24, 7, 9), 4, torch.bfloat16, torch.bfloat16),
    ((1, 128, 256, 256), 32, torch.bfloat16, torch.bfloat16),
    ((1, 128, 512, 512), 32, torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("silu,tokens", [(True, False), (False, True)])
def test_group_norm_kernel_other_shapes(card, shape, groups, dtype, out, layout, silu, tokens):
    import chip_smoke as cs
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.ops import norms

    x, w, b = cs.norm_case(shape, layout, torch.Generator(device="cuda").manual_seed(6), dtype)
    kernels.reset_counts()
    got, mean, rstd = norms.group_norm_kernel(x, groups, w, b, 1e-6, silu, out, tokens)
    want = norms.group_norm_plain(x, groups, w, b, 1e-6, silu, out, tokens)
    assert kernels.COUNTS["group_norm_fwd"] == 1
    assert cs.norm_error(got, want) <= 1.0
    n, c, h, wd = shape
    _, want_mean, want_rstd = torch.ops.aten.native_group_norm(
        x.float().contiguous(), w, b, n, c, h * wd, groups, 1e-6)
    torch.testing.assert_close(mean, want_mean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, want_rstd, rtol=1e-5, atol=0)


# the tiny stacks' rows, a float32 input before a bf16 layer, rows of no
# whole 16-byte vectors (36 bf16) and rows longer than a lane's registers
# hold (2,560 bf16)
@pytest.mark.parametrize("shape,dtype,out", [
    ((2, 1024, 32), torch.float32, torch.float32),
    ((2, 256, 64), torch.float32, torch.float32),
    ((2, 3, 36), torch.float32, torch.bfloat16),
    ((3, 5, 36), torch.bfloat16, torch.bfloat16),
    ((4, 7, 2560), torch.bfloat16, torch.bfloat16)])
def test_layer_norm_kernel_other_shapes(card, shape, dtype, out):
    import chip_smoke as cs
    from dreamscene_tpu_torch.ops import norms

    x, w, b = cs.norm_case(shape, "nchw", torch.Generator(device="cuda").manual_seed(7), dtype)
    got, mean, rstd = norms.layer_norm_kernel(x, w, b, 1e-6, out)
    assert cs.norm_error(got, norms.layer_norm_plain(x, w, b, 1e-6, out)) <= 1.0
    _, want_mean, want_rstd = torch.ops.aten.native_layer_norm(x.float(), w.shape, w, b, 1e-6)
    torch.testing.assert_close(mean, want_mean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, want_rstd, rtol=1e-5, atol=0)


def test_replayed_pass_counts_its_captured_norm_launches(card):
    """A UNet pass launches one norm kernel a norm (the tiny UNet: 21 group,
    12 layer), eager, captured or replayed from its CUDA graph."""
    import dataclasses

    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.guidance import sd_modules as sdm
    from dreamscene_tpu_torch.guidance import unet_graph as ug

    gen = torch.Generator(device="cuda").manual_seed(8)
    with torch.device("cuda"):
        unet = sdm.init_random_(sdm.UNet2DCondition(
            dataclasses.replace(sdm.tiny_unet_config(), dtype=torch.bfloat16)), gen)
    unet.requires_grad_(False)
    args = (torch.randn((2, 4, 32, 32), generator=gen, device="cuda"),
            torch.full((2,), 500, device="cuda"),
            torch.randn((2, 4, 32), generator=gen, device="cuda"))
    passes, deltas = ug.UNetPasses(), []
    kernels.reset_counts()
    with torch.no_grad():
        for _ in range(ug.CAPTURE_AT + 2):
            before = kernels.COUNTS.copy()
            passes(unet, [unet], args)
            deltas.append({k: kernels.COUNTS[k] - before[k]
                           for k in ("group_norm_fwd", "layer_norm_fwd", "norm.torch_elems")})
    torch.cuda.synchronize()
    assert kernels.COUNTS[ug.CAPTURE] == 1 and kernels.COUNTS[ug.REPLAY] == 2
    assert deltas == [{"group_norm_fwd": 21, "layer_norm_fwd": 12,
                       "norm.torch_elems": 0}] * (ug.CAPTURE_AT + 2), deltas


def test_encoder_under_autograd_takes_the_differentiable_norms(card, monkeypatch):
    """The VAE encoder differentiated with respect to its images (as in the
    FPS step) launches one norm kernel a norm (the tiny encoder: 10) inside
    the kernels' autograd Function, whose backward takes every element once
    (`norm.torch_elems`), and the images' gradient equals that of the plain
    versions within `chip_smoke.norm_error`'s tolerance. Without autograd
    it launches one kernel a norm as well."""
    import chip_smoke as cs
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.guidance import sd_modules as sdm
    from dreamscene_tpu_torch.ops import norms

    gen = torch.Generator(device="cuda").manual_seed(9)
    with torch.device("cuda"):
        enc = sdm.init_random_(sdm.VAEEncoder(sdm.tiny_vae_config()), gen)
    enc.requires_grad_(False)
    img = torch.rand((1, 3, 64, 64), generator=gen, device="cuda")

    def grad():
        x = img.clone().requires_grad_(True)
        enc(x).sum().backward()
        torch.cuda.synchronize()
        return x.grad

    kernels.reset_counts()
    got = grad()
    assert torch.isfinite(got).all()
    assert kernels.COUNTS["group_norm_fwd"] == 10 and kernels.COUNTS["layer_norm_fwd"] == 0
    assert kernels.COUNTS["norm.torch_elems"] == kernels.COUNTS["norm.kernel_elems"] > 0
    with torch.no_grad():
        enc(img)
    assert kernels.COUNTS["group_norm_fwd"] == 20
    with monkeypatch.context() as m:
        m.setattr(norms, "path", lambda *t: "plain")
        want = grad()
    assert kernels.COUNTS["group_norm_fwd"] == 20
    assert cs.norm_error(got, want) <= 1.0


@pytest.mark.parametrize("shape,dtype,out,silu,tokens", [
    ((2, 96, 32, 32), torch.float32, torch.float32, True, False),
    ((2, 24, 7, 9), torch.bfloat16, torch.bfloat16, False, True),
    ((1, 128, 256, 256), torch.bfloat16, torch.bfloat16, True, False),
    ((2, 3, 36), torch.bfloat16, torch.bfloat16, False, False),
    ((4, 7, 640), torch.float32, torch.bfloat16, False, False)])
def test_norm_gradients_from_kernel_moments_match_plain(card, shape, dtype, out, silu, tokens):
    """x's, the weight's and the bias's gradients through the kernels'
    autograd Function (group norm for 4-d shapes, layer norm otherwise)
    against autograd of the plain versions, within `chip_smoke.norm_error`'s
    tolerance; the weight's and bias's sums over the batch get 1e-5 of the
    largest term's scale."""
    import chip_smoke as cs
    from dreamscene_tpu_torch.ops import norms

    gen = torch.Generator(device="cuda").manual_seed(10)
    x, w, b = cs.norm_case(shape, "nchw", gen, dtype)
    group = len(shape) == 4
    dy_shape = (shape[0], shape[2] * shape[3], shape[1]) if tokens else shape
    dy = torch.randn(dy_shape, device="cuda", generator=gen).to(out)
    grads = []
    for way in ("kernel", "plain"):
        xg, wg, bg = (t.detach().requires_grad_(True) for t in (x, w, b))
        if group:
            y = (norms.group_norm(xg, 4, wg, bg, 1e-6, silu, out, tokens) if way == "kernel"
                 else norms.group_norm_plain(xg, 4, wg, bg, 1e-6, silu, out, tokens))
        else:
            y = (norms.layer_norm(xg, wg, bg, 1e-6, out) if way == "kernel"
                 else norms.layer_norm_plain(xg, wg, bg, 1e-6, out))
        y.backward(dy)
        grads.append((xg.grad, wg.grad, bg.grad))
    (dx, dw, db), (px, pw, pb) = grads
    assert cs.norm_error(dx, px) <= 1.0
    scale = float(dy.float().abs().sum() / shape[-1 if not group else 1])
    torch.testing.assert_close(dw, pw, rtol=1e-5, atol=1e-5 * scale)
    torch.testing.assert_close(db, pb, rtol=1e-5, atol=1e-5 * scale)
