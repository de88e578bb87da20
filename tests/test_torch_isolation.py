"""Isolation of the port: it imports neither JAX nor the JAX package (nor
transformers or safetensors, which the card's machine lacks), and its
entry points refuse to fall back to the CPU on their own."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "dreamscene_tpu_torch"


def port_modules():
    mods = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'flax', 'dreamscene_tpu', 'transformers', 'safetensors'))\n"
        "print(','.join(bad))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", f"port pulled in: {res.stdout.strip()}"


def test_sources_name_no_jax():
    pat_jax = re.compile(r"^\s*(import|from)\s+(jax|flax)\b", re.M)
    pat_pkg = re.compile(r"dreamscene_tpu(?!_torch)\b")
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for p in files:
        src = p.read_text()
        assert not pat_jax.search(src), f"{p} imports jax/flax"
        for line in src.splitlines():
            code = line.split("#")[0]
            if ("import" in code) and pat_pkg.search(code):
                raise AssertionError(f"{p} imports the JAX package: {line}")


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_render_without_cpu_request_raises(monkeypatch):
    from dreamscene_tpu_torch.ops.rasterizer import render

    _no_cuda(monkeypatch)
    n = 8
    args = dict(means3d=torch.zeros(n, 3), scales=torch.ones(n, 3), quats=torch.ones(n, 4),
                opacities=torch.ones(n), shs=torch.zeros(n, 1, 3),
                viewmatrix=torch.eye(4), projmatrix=torch.eye(4), campos=torch.zeros(3),
                tanfovx=0.5, tanfovy=0.5, width=32, height=32, bg=torch.zeros(3),
                sh_degree=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render(**args)
    out = render(**args, device="cpu")
    assert out["image"].shape == (3, 32, 32)


def test_trainer_and_guidance_without_cpu_request_raise(monkeypatch, tmp_path):
    from dreamscene_tpu_torch.guidance import mtsd
    from dreamscene_tpu_torch.training.object_trainer import ObjectTrainer
    from dreamscene_tpu_torch.utils.config import ObjectsParamsGroups

    _no_cuda(monkeypatch)
    cfg = ObjectsParamsGroups()
    cfg.log = {"exp_name": "iso"}
    cfg.objectParams.init_guided = "default"
    cfg.objectParams.num_pts = 20
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ObjectTrainer(cfg, exp_root=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mtsd.make_tiny_guidance(cfg.guidanceParams)
    from dreamscene_tpu_torch.guidance.clip_text import make_clip_text_encoder
    from dreamscene_tpu_torch.guidance.sd_loader import build_sd_guidance

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_sd_guidance(str(tmp_path), cfg.guidanceParams)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_clip_text_encoder(str(tmp_path))
    tr = ObjectTrainer(cfg, exp_root=str(tmp_path), device="cpu")
    assert tr.state.device.type == "cpu"


def test_scene_trainer_without_cpu_request_raises(monkeypatch, tmp_path):
    from dreamscene_tpu_torch.training.scene_trainer import SceneTrainer
    from dreamscene_tpu_torch.utils.config import load_config

    _no_cuda(monkeypatch)
    cfg = load_config(str(ROOT / "configs" / "scenes" / "sample_indoor.yaml"), ["log.exp_name=iso"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SceneTrainer(cfg, exp_root=str(tmp_path))
    assert SceneTrainer(cfg, exp_root=str(tmp_path), device="cpu").device.type == "cpu"


def test_kernel_wrappers_take_plain_path_only_for_cpu_tensors():
    """CPU tensors run the plain versions and never touch the kernel
    library or its launch counters."""
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.ops.expand import expand_entries

    kernels.reset_counts()
    offsets = torch.tensor([0, 2, 3], dtype=torch.int32)
    key, gid = expand_entries(offsets, torch.tensor([1, 2, 1], dtype=torch.int32),
                              torch.tensor([2, 0, 1], dtype=torch.int32),
                              torch.tensor(4, dtype=torch.int32), capacity=6, n=3,
                              n_tiles=4, tiles_x=2, shift=2)
    assert key.device.type == "cpu"
    np.testing.assert_array_equal(gid.numpy(), [2, 2, 0, 1, 1, 1])
    assert all(v == 0 for v in kernels.COUNTS.values())
    assert kernels._LIB is None


def test_kernel_signatures_match_the_exported_launchers():
    """The library's ctypes signatures are exactly the `extern "C" int ds_*`
    launchers of csrc/*.cu, each with as many arguments as its C
    declaration: without a card nothing else notices an entry whose launcher
    is gone, or a launcher exported for no caller of the library."""
    from dreamscene_tpu_torch import kernels

    decl = re.compile(r'extern "C" int (ds_\w+)\s*\(([^)]*)\)')
    found = {}
    for src in sorted(kernels.CSRC.glob("*.cu")):
        for name, params in decl.findall(src.read_text()):
            assert name not in found, f"{name} exported twice"
            found[name] = len(params.split(","))
    assert set(kernels._SIGNATURES) == set(found)
    assert {k: len(v) for k, v in kernels._SIGNATURES.items()} == found
