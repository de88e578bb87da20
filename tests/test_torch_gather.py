"""The port's 32-bit row gathers against the JAX package's uint16-halves
gathers they stand for: bit-equal on every bit pattern (-0.0, infinities,
subnormals, NaN payloads, the int32 extremes), repeated indices
included."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dreamscene_tpu.ops import gather as jgather
from dreamscene_tpu_torch.ops import gather as tgather

# One intra-op thread: the suite runs several worker processes at once, and
# one OpenMP team of all cores per worker makes these small tensors wait on
# each other (the six heaviest files of the port took 205 s on 8 cores with
# 6 workers, 66 s with one thread each).
torch.set_num_threads(1)

SPECIAL_BITS = np.array([0x80000000, 0x7F800000, 0xFF800000, 0x00000001, 0x807FFFFF,
                         0x7FC00000, 0x7F800001, 0xFFC12345, 0x7FBFFFFF, 0x3F800000],
                        np.uint32)
INT_EXTREMES = np.array([-2**31, 2**31 - 1, -1, 0, 1, -2**31 + 1], np.int64)


def table(kind, n=257, w=10, seed=0):
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 2**32, size=(n, w), dtype=np.uint64).astype(np.uint32)
    specials = SPECIAL_BITS if kind == "f32" else INT_EXTREMES.astype(np.int32).view(np.uint32)
    bits.reshape(-1)[:specials.size * 7:7] = specials
    return bits.view(np.float32 if kind == "f32" else np.int32)


@pytest.mark.parametrize("kind", ["f32", "i32"])
def test_row_gather_bit_equal_to_u16_halves(kind):
    src = table(kind)
    idx = np.random.RandomState(1).randint(0, src.shape[0], size=1000).astype(np.int32)
    idx[:4] = [0, src.shape[0] - 1, 0, 0]
    if kind == "f32":
        ref = jgather.u16_row_gather(jnp.asarray(src), jnp.asarray(idx))
        got = tgather.row_gather(torch.from_numpy(src), torch.from_numpy(idx))
        assert got.dtype == torch.float32
    else:
        ref = jgather.u16_row_gather_i32(jnp.asarray(src), jnp.asarray(idx))
        got = tgather.row_gather_i32(torch.from_numpy(src), torch.from_numpy(idx))
        assert got.dtype == torch.int32
    ref = np.asarray(ref).view(np.uint32)
    assert np.array_equal(got.numpy().view(np.uint32), ref)
    assert np.array_equal(ref, src.view(np.uint32)[idx])
