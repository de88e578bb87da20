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
