"""The port's image losses (`l1_loss`, `safe_normalize`, `ssim`) and
profiling helpers (`roofline`, `timed`, `trace`, `seed_everything`)
against the JAX package's on the same numpy inputs.

Tolerances: `l1_loss` and `safe_normalize` rtol 1e-6 (float32 reductions
in another order); `ssim` atol 1e-6 (five depthwise 11x11 convolutions,
XLA's against PyTorch's), its gradient w.r.t. img1 within 1e-5 of max|g|;
`roofline` exactly.
"""

import json
import logging
import os
import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dreamscene_tpu.ops import losses as jloss
from dreamscene_tpu.utils import profiling as jprof
from dreamscene_tpu_torch.ops import losses as tloss
from dreamscene_tpu_torch.utils import profiling as tprof

# One intra-op thread: the suite runs several worker processes at once, and
# one OpenMP team of all cores per worker makes these small tensors wait on
# each other (the six heaviest files of the port took 205 s on 8 cores with
# 6 workers, 66 s with one thread each).
torch.set_num_threads(1)


def image_pair(seed, shape=(2, 3, 40, 36)):
    rng = np.random.RandomState(seed)
    a = rng.rand(*shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*shape), 0, 1).astype(np.float32)
    return a, b


def test_l1_loss_matches_jax():
    a, b = image_pair(0)
    ref = float(jloss.l1_loss(jnp.asarray(a), jnp.asarray(b)))
    got = float(tloss.l1_loss(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_safe_normalize_matches_jax():
    x = np.random.RandomState(1).randn(64, 3).astype(np.float32)
    x[0] = 0.0                                   # the eps floor: 0 stays 0, no NaN
    x[1] = [1e-12, 0.0, 0.0]
    ref = np.asarray(jloss.safe_normalize(jnp.asarray(x)))
    got = tloss.safe_normalize(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all() and not got[0].any()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("size_average", [True, False])
def test_ssim_matches_jax(size_average):
    a, b = image_pair(2)
    ref = np.asarray(jloss.ssim(jnp.asarray(a), jnp.asarray(b), size_average=size_average))
    got = tloss.ssim(torch.from_numpy(a), torch.from_numpy(b), size_average=size_average)
    assert tuple(got.shape) == ref.shape == (() if size_average else (2,))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


def test_ssim_gradient_matches_jax():
    a, b = image_pair(3)
    ref = np.asarray(jax.grad(lambda x: jloss.ssim(x, jnp.asarray(b)))(jnp.asarray(a)))
    x = torch.from_numpy(a).requires_grad_(True)
    tloss.ssim(x, torch.from_numpy(b)).backward()
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(x.grad.numpy(), ref, atol=1e-5 * scale, rtol=0)


def test_gaussian_window_matches_jax():
    w = tloss._gaussian_window(11, 1.5)
    assert w.dtype == np.float32 and np.array_equal(w, jloss._gaussian_window(11, 1.5))


def test_roofline_matches_jax():
    args = (3.2e12, 4.1e9, 0.0125)
    peaks = dict(peak_flops=197e12, peak_bw=819e9)
    assert tprof.roofline(*args, **peaks) == jprof.roofline(*args, **peaks)
    got = tprof.roofline(*args)
    assert got["flops_frac"] == args[0] / args[2] / 989e12
    assert got["bw_frac"] == args[1] / args[2] / 3.35e12
    assert (tprof.H100_BF16_FLOPS, tprof.H100_FP32_FLOPS,
            tprof.H100_HBM_BYTES_PER_S) == (989e12, 67e12, 3.35e12)


def test_timed_logs_like_jax(caplog):
    sync = {"a": torch.ones(3), "b": [torch.zeros(2), (torch.ones(1),)]}
    with caplog.at_level(logging.INFO, logger="dreamscene_tpu_torch"):
        with tprof.timed("render", sync=sync):
            pass
    (rec,) = [r for r in caplog.records if r.name == "dreamscene_tpu_torch"]
    assert rec.msg == "%s: %.2f ms" and rec.args[0] == "render"
    assert rec.getMessage().startswith("render: ") and rec.getMessage().endswith(" ms")


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with tprof.trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = tmp_path.iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)


def test_seed_everything_matches_jax(monkeypatch):
    monkeypatch.delenv("PYTHONHASHSEED", raising=False)
    jprof.seed_everything(1234)
    ref = (random.random(), np.random.rand(), os.environ["PYTHONHASHSEED"])
    monkeypatch.delenv("PYTHONHASHSEED")
    tprof.seed_everything(1234)
    assert (random.random(), np.random.rand(), os.environ["PYTHONHASHSEED"]) == ref
