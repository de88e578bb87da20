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

    st, cam = cs.make_scene(3000, 128, 96, seed=5)
    inp = cs.binned_inputs(st, cam, tile_w, tile_h)
    errs, _ = cs.check_kernels(f"pytest {tile_w}x{tile_h}", inp, timing=False)
    assert errs["expand_entries"] == 0.0


@pytest.mark.parametrize("shape,dtype", [((2, 3, 1024, 64), torch.bfloat16),
                                         ((1, 1, 1024, 512), torch.bfloat16),
                                         ((1, 2, 256, 40), torch.float32),
                                         ((1, 1, 384, 256), torch.float32)])
def test_flash_kernels_match_plain_versions(card, shape, dtype):
    import chip_smoke as cs

    row = cs.check_flash(f"pytest {shape}", shape, dtype, timing=False)
    assert set(row["errs"]) == {"flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"}
