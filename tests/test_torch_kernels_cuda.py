"""The hand-written CUDA kernels against their plain PyTorch versions on
the card (the check chip_smoke.py phase 2 makes, at a small size).

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
