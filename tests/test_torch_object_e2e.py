"""Object generation end to end on the CPU: `ObjectTrainer.train()` and the
CLI at a tiny size (plain versions of the kernels), with the final PLY read
back by the JAX package's loader.

These are the port's longest tests; they live in a file of their own so that
a run that hands whole files to its workers (`--dist loadfile`) does not
queue them behind the parity tests of tests/test_torch_object_train.py.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from dreamscene_tpu.models import ply as JP
from dreamscene_tpu_torch.cameras import sampling as TS
from dreamscene_tpu_torch.models import gaussians as TG
from dreamscene_tpu_torch.training import object_trainer as TOT
from dreamscene_tpu_torch.utils.config import ObjectsParamsGroups as TCfg

# One intra-op thread: the suite runs several worker processes at once, and
# with one OpenMP team of all cores per worker these tiny tensors spend the
# run waiting on each other (train() took 138 s beside five busy workers and
# 9 s with one thread each).
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _tiny_cfg(cfg, **over):
    cfg.log = {"exp_name": "t"}
    cfg.objectParams.id = "obj1"
    cfg.objectParams.init_guided = "default"
    cfg.objectParams.num_pts = 40
    cfg.objectParams.sh_degree = 1
    cfg.objectParams.text = "a thing"
    cfg.optimizationParams.iterations = 3
    cfg.optimizationParams.max_point_number = 400
    cfg.guidanceParams.C_batch_size = 2
    cfg.generateCamParams.image_w = 32
    cfg.generateCamParams.image_h = 32
    cfg.mode_args = {}
    for k, v in over.items():
        group, name = k.split("__")
        setattr(getattr(cfg, group), name, v)
    return cfg


def _check_final_ply(exp_dir: Path, obj_id: str, n_active: int | None = None):
    final = exp_dir / "checkpoints" / f"{obj_id}_final_model.ply"
    assert final.exists()
    jst = JP.load_splat_ply(str(final))
    n = int(jst.aux.active.sum())
    assert n > 0 and np.isfinite(np.asarray(jst.params.xyz)).all()
    if n_active is not None:
        assert n == n_active
    return n


def test_train_end_to_end_cpu(tmp_path, monkeypatch):
    """A tiny train(): FPS steps with densify/prune, opacity reset and viz
    every second step, a snapshot, the refine phase with one recon
    densify, videos (on a 6-camera orbit here) and the final PLY (read
    back by the JAX loader)."""
    clip = TS.load_clip_cam
    monkeypatch.setattr(TOT.S, "load_clip_cam", lambda opt: clip(opt, size=3))
    cfg = _tiny_cfg(TCfg(), optimizationParams__densify_from_iter=1,
                    optimizationParams__densification_interval=2,
                    optimizationParams__opacity_reset_interval=2,
                    guidanceParams__vis_interval=2, reconOptimizationParams__iterations=1,
                    reconOptimizationParams__densification_interval=5)
    cfg.optimizationParams.iterations = 2
    tr = TOT.ObjectTrainer(cfg, exp_root=str(tmp_path), device="cpu")
    tr.train(make_videos=True, video_every=2)
    assert tr.step == 3 and tr.rec_count == 18
    vis = tr.exp_path / "vis"
    assert list(vis.glob("obj1_iter_2_vd_*"))
    assert list(vis.glob("video_rgb_obj1_final.mp4*")) and list(vis.glob("video_rgb_obj1_2.mp4*"))
    assert (tr.ckpt_path / "obj1_2_model.ply").exists()
    _check_final_ply(tr.exp_path, "obj1", TG.num_active(tr.state))
    # a finished object is loaded, not trained again
    again = TOT.ObjectTrainer(cfg, exp_root=str(tmp_path), device="cpu")
    again.train()
    assert again.step == 0 and TG.num_active(again.state) == TG.num_active(tr.state)


def test_cli_end_to_end_cpu(tmp_path):
    """The port's CLI with the verify recipe's tiny overrides."""
    cmd = [sys.executable, "-m", "dreamscene_tpu_torch", "--object", "--config",
           "configs/objects/sample.yaml", "--device", "cpu", "--exp-root", str(tmp_path),
           "objectParams.init_guided=default", "objectParams.num_pts=40",
           "objectParams.sh_degree=1", "optimizationParams.iterations=2",
           "reconOptimizationParams.iterations=1", "guidanceParams.C_batch_size=2",
           "generateCamParams.image_w=32", "generateCamParams.image_h=32",
           "optimizationParams.densify_from_iter=100", "guidanceParams.vis_interval=1"]
    env = dict(os.environ, OMP_NUM_THREADS="1")   # see torch.set_num_threads above
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    exp = tmp_path / "object_sample"
    assert list((exp / "vis").glob("armor_iter_1_vd_*"))
    _check_final_ply(exp, "armor")
