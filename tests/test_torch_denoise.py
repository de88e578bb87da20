"""The port's CFG denoising walk (`mtsd.denoise_ladder`, the reference's
denoise_with_cfg) against the JAX package's on the tiny guidance stack
with a ControlNet whose zero convs are filled, the JAX weights carried
across by `convert.py`: every rung's (cond, uncond, blank) triple and
latent, with and without a depth hint, from clean and from noisy latents.

Tolerance: atol 1e-4, as the ladder's parity test (float32 on both sides;
convolution and reduction orders differ).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dreamscene_tpu.guidance import mtsd as jm
from dreamscene_tpu_torch.guidance import mtsd as tm
from tests.test_torch_controlnet import jax_cn_guidance, port_mods

# One intra-op thread: the suite runs several worker processes at once, and
# one OpenMP team of all cores per worker makes these small tensors wait on
# each other (the six heaviest files of the port took 205 s on 8 cores with
# 6 workers, 66 s with one thread each).
torch.set_num_threads(1)

ATOL = 1e-4


@pytest.fixture(scope="module")
def stacks():
    jg = jax_cn_guidance(seed=1)
    return jg, port_mods(jg.mods)


@pytest.mark.parametrize("hint", [False, True], ids=["no hint", "depth hint"])
@pytest.mark.parametrize("noisy", [False, True], ids=["clean latents", "noisy latents"])
def test_denoise_ladder_matches_jax(stacks, hint, noisy):
    jg, mods = stacks
    rng = np.random.RandomState(5)
    b = 2
    lat = rng.randn(b, 8, 8, 4).astype(np.float32)
    noise = rng.randn(b, 8, 8, 4).astype(np.float32)
    emb = rng.randn(3 * b, 4, 32).astype(np.float32)
    cond = rng.rand(b, 16, 16, 3).astype(np.float32) if hint else None
    ts = [700, 480, 230]
    kw = dict(n_rungs=len(ts), cfg=7.5, is_noisy_latent=noisy)
    ref = jm.denoise_ladder(jg.mods, jnp.asarray(lat), jnp.asarray(noise),
                            jnp.asarray(ts, jnp.int32), jnp.asarray(emb),
                            cond_image=None if cond is None else jnp.asarray(cond), **kw)
    got = tm.denoise_ladder(mods, torch.from_numpy(lat), torch.from_numpy(noise), ts,
                            torch.from_numpy(emb),
                            cond_image=None if cond is None else torch.from_numpy(cond), **kw)
    assert len(got) == len(ref) == len(ts)
    for (jt, jtrip, jlat), (tt, ttrip, tlat) in zip(ref, got):
        assert int(jt) == tt
        np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), atol=ATOL)
        for a, c in zip(jtrip, ttrip):
            np.testing.assert_allclose(c.numpy(), np.asarray(a), atol=ATOL)
    if noisy:
        assert np.array_equal(got[0][2].numpy(), lat)       # the walk starts from them
    assert float((got[-1][2] - got[0][2]).abs().max()) > 1e-2   # the walk moved
