"""The SD validation harness: the port's `run_validation` against the
JAX package's on the tiny stack with SD's latent factor (downscale 8),
the JAX weights carried across by `convert.py` and the JAX harness's own
random draws (its seeded probe latent, posterior eps and ladder noise,
recomputed from the same keys), and the `--tiny` CLI on the CPU.

Tolerances: the same report keys; decode_finite and csd_grad_nan equal;
roundtrip_psnr_db and csd_grad_norm rtol 1e-4; the bf16-vs-fp32 deltas
of the float32 tiny UNet exactly 0 on both sides.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import torch

from dreamscene_tpu.guidance import mtsd as jm
from dreamscene_tpu.guidance import validate as JV
from dreamscene_tpu.utils.config import GuidanceParams as JGuidanceParams
from dreamscene_tpu_torch import convert
from dreamscene_tpu_torch.guidance import mtsd as tm
from dreamscene_tpu_torch.guidance import sd_modules as sdm
from dreamscene_tpu_torch.guidance import validate as TV
from dreamscene_tpu_torch.utils.config import GuidanceParams

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SIZE = 64
FILES = {"decode_probe.jpg", "roundtrip.jpg", "ladder_grid.jpg", "report.json"}


def written(out: Path) -> set:
    """The harness's files (a grid is `<name>.npy` without imageio)."""
    return {p.name[:-4] if p.name.endswith(".jpg.npy") else p.name for p in out.iterdir()}


def test_run_validation_matches_jax(tmp_path):
    jg = jm.make_tiny_guidance(JGuidanceParams(), downscale=8)
    ucfg = sdm.tiny_unet_config()
    vcfg = dataclasses.replace(sdm.tiny_vae_config(), block_out_channels=(32,) * 4,
                               layers_per_block=1)
    tree = jax.tree.map(np.asarray, (jg.mods.unet_params, jg.mods.vae_encode_params,
                                     jg.mods.vae_decode_params))
    mods = convert.guidance_modules(convert.unet_state_dict(tree[0], ucfg),
                                    convert.vae_encoder_state_dict(tree[1], vcfg),
                                    convert.vae_decoder_state_dict(tree[2], vcfg), ucfg, vcfg)
    assert mods.downscale == jg.mods.downscale == 8
    tg = tm.MTSD(mods=mods, text_encode=tm.crc32_text_encoder(4, 32, "cpu"),
                 guidance_opt=GuidanceParams(), device=torch.device("cpu"))

    shape = (1, SIZE // 8, SIZE // 8, 4)
    draws = dict(
        latent=jax.random.normal(jax.random.key(0), shape),
        posterior_eps=jax.random.normal(jax.random.key(1), shape, jnp.float32),
        ladder_noise=jm.make_ladder_noise(jax.random.key(2), shape))
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    want = JV.run_validation(jg, str(tmp_path / "jax"), size=SIZE)
    got = TV.run_validation(tg, str(tmp_path / "port"), size=SIZE, draws=draws)
    assert set(got) == set(want) == {"decode_finite", "roundtrip_psnr_db", "csd_grad_norm",
                                     "csd_grad_nan", "unet_bf16_delta_max",
                                     "unet_bf16_delta_mean"}
    assert got["decode_finite"] is want["decode_finite"] is True
    assert got["csd_grad_nan"] == want["csd_grad_nan"] == 0
    for k in ("roundtrip_psnr_db", "csd_grad_norm"):
        assert math.isclose(got[k], want[k], rel_tol=1e-4), (k, got[k], want[k])
    assert got["unet_bf16_delta_max"] == want["unet_bf16_delta_max"] == 0.0
    assert written(tmp_path / "port") == written(tmp_path / "jax") == FILES
    assert json.loads((tmp_path / "port" / "report.json").read_text()) == got


def test_float32_unet_copy_leaves_the_live_module():
    unet = sdm.init_random_(sdm.UNet2DCondition(dataclasses.replace(
        sdm.tiny_unet_config(), dtype=torch.bfloat16)), torch.Generator().manual_seed(0))
    hi = TV.float32_unet(unet)
    assert hi.cfg.dtype == torch.float32 and unet.cfg.dtype == torch.bfloat16
    for (k, a), (_, b) in zip(unet.state_dict().items(), hi.state_dict().items()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), k


def test_tiny_cli_on_the_cpu(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "dreamscene_tpu_torch.guidance.validate", "--tiny",
           "--size", str(SIZE), "--out", str(tmp_path / "out")]
    res = subprocess.run(cmd + ["--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    report = json.loads((tmp_path / "out" / "report.json").read_text())
    assert report["decode_finite"] and report["csd_grad_nan"] == 0
    assert all(math.isfinite(v) for v in report.values())
    assert written(tmp_path / "out") == FILES
    # without --device cpu it asks for the card and refuses to fall back
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "CUDA is not available" in res.stderr
