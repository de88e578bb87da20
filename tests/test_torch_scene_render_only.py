"""`only_render` and the CLI's scene mode on the outdoor config, on the CPU.

- `train()` with `only_render=True` in the port against the JAX package,
  indoor and outdoor, at the tiny size of tests/test_torch_scene_step.py:
  it returns None before any stage (no stage checkpoint, `stage_n` 0);
  `scene_cams_inference` (the walkthrough: three lines, three arcs, a
  circle) holds the JAX trainer's cameras bit for bit; the first frames
  (`max_frames`; the lines render at 512x512 whatever the config) match
  the JAX package's `scene_render` at atol 1e-5 / rtol 1e-4 (image,
  depth, alpha); the rgb and depth videos are written (`.mp4`, or
  `.mp4.npz` without imageio).
- The CLI (`python -m dreamscene_tpu_torch`, in process) on
  configs/scenes/sample_outdoor.yaml: its two objects written as finished
  PLYs, stages 1-3 with stage 3's iterations cut to 1, the floor-only
  refine moving the floor and not the env; then `only_render=true`
  renders the walkthrough from those checkpoints and writes no
  checkpoint.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from dreamscene_tpu.rendering import scene_render as j_scene_render
from dreamscene_tpu.training import scene_trainer as jst
from dreamscene_tpu.utils.config import ParamsGroups as JCfg
from dreamscene_tpu_torch.cameras import Camera as TCamera
from dreamscene_tpu_torch.models.gaussians import PARAM_FIELDS
from dreamscene_tpu_torch.training import scene_trainer as tst
from dreamscene_tpu_torch.utils.config import ParamsGroups as TCfg
from tests.test_torch_scene_outdoor import tiny_outdoor_cfg
from tests.test_torch_scene_step import ENV_DENSITY, tiny_scene_cfg, write_objects

torch.set_num_threads(1)

MAX_FRAMES = 2
# every field of the camera dataclass, and the matrices the renderer reads
CAM_FIELDS = tuple(f.name for f in dataclasses.fields(TCamera)) + (
    "world_view_transform", "full_proj_transform")


def _video_files(vis_path, tag):
    return [p for kind in ("rgb", "depth")
            for p in vis_path.glob(f"video_{kind}_scene_{tag}.mp4*")]


@pytest.mark.parametrize("method", ["indoor", "outdoor"])
def test_only_render_matches_jax(tmp_path, monkeypatch, method):
    make_cfg = tiny_outdoor_cfg if method == "outdoor" else tiny_scene_cfg
    jcfg, tcfg = make_cfg(JCfg()), make_cfg(TCfg())
    jcfg.only_render = tcfg.only_render = True
    jtr = jst.SceneTrainer(jcfg, exp_root=str(tmp_path / "j"), interpret=True,
                           env_density=ENV_DENSITY)
    ttr = tst.SceneTrainer(tcfg, exp_root=str(tmp_path / "t"), device="cpu",
                           env_density=ENV_DENSITY)
    write_objects(jtr.ckpt_path)
    write_objects(ttr.ckpt_path)
    # the JAX walkthrough is only recorded; the port's renders its first
    # frames and writes both videos, its renders captured
    walk = {}
    jtr.scene_video_inference = lambda tag, only_env=False, max_frames=None: walk.update(
        tag=tag, only_env=only_env)
    ttr.scene_video_inference = functools.partial(ttr.scene_video_inference,
                                                  max_frames=MAX_FRAMES)
    frames, render = [], tst.scene_render

    def capture(states, cam, **kw):
        out = render(states, cam, **kw)
        frames.append((states, cam, kw, out))
        return out

    monkeypatch.setattr(tst, "scene_render", capture)
    assert jtr.train() is None and ttr.train() is None
    assert walk == {"tag": "render", "only_env": False}
    for tr in (jtr, ttr):
        assert tr.scene.stage_n == 0
        assert not list(tr.scene_ckpt_path.iterdir())
    jcams, tcams = jtr.scene_cams_inference, ttr.scene_cams_inference
    assert len(tcams) == len(jcams) > 100
    for jc, tc in zip(jcams, tcams):
        for f in CAM_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(tc, f)), np.asarray(getattr(jc, f)),
                                          err_msg=f)
    assert (tcams[0].width, tcams[0].height) == (512, 512)
    assert len(_video_files(ttr.vis_path, "render")) == 2

    assert len(frames) == MAX_FRAMES
    j_states = jtr._states(list(jtr.scene.objects))
    n_rows = sum(s.capacity for s in j_states)
    for i, (states, cam, kw, out) in enumerate(frames):
        assert sum(s.capacity for s in states) == n_rows
        assert kw == {"bg_color": ttr.bg_color}
        assert cam is tcams[i]
        jout = j_scene_render(j_states, jcams[i], bg_color=jtr.bg_color, test=True,
                              interpret=True)
        assert int(out["n_entries"]) == int(jout["n_entries"]) > 0
        for k in ("image", "depth", "alpha"):
            np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), atol=1e-5,
                                       rtol=1e-4, err_msg=k)


def test_cli_outdoor_scene_then_only_render(tmp_path, monkeypatch):
    """`python -m dreamscene_tpu_torch --config configs/scenes/
    sample_outdoor.yaml` (steve and creeper written as finished PLYs, so
    point-e is never called) through stage 3 with train()'s stage-3
    iterations cut to 1; the floor-only refine leaves the env as stage 2
    left it and moves the floor. A second call with `only_render=true`
    resumes the scene from the stage-3 checkpoint, renders the walkthrough
    (its first frame: a 512x512 render takes ~10 s on one CPU thread) and
    writes no checkpoint."""
    from dreamscene_tpu_torch import __main__ as cli

    monkeypatch.setattr(tst.SceneTrainer, "train",
                        functools.partialmethod(tst.SceneTrainer.train, n_stage3=1))
    exp = tmp_path / "cli"
    (exp / "checkpoints").mkdir(parents=True)
    write_objects(exp / "checkpoints", ("steve", "creeper"))
    args = ["--config", "configs/scenes/sample_outdoor.yaml", "--device", "cpu",
            "--exp-root", str(tmp_path), "--env-density", str(ENV_DENSITY),
            "scene_configs.scene.compress_n_views=4", "sceneOptimizationParams.iterations=2",
            "guidanceParams.C_batch_size=2", "generateCamParams.image_w=32",
            "generateCamParams.image_h=32", "sceneGenerateCamParams.image_w=32",
            "sceneGenerateCamParams.image_h=32", "log.exp_name=cli"]
    assert cli.main(args) == 0
    ckpts = exp / "scene_checkpoints"
    final = ckpts / "scene_final_model.ply"
    assert final.exists()
    assert (exp / "checkpoints" / "creeper_final_model_compressed.ply").exists()
    with np.load(ckpts / "scene_2_stage.ckpt.npz") as s2, \
            np.load(ckpts / "scene_3_stage.ckpt.npz") as s3:
        assert int(s3["stage_n"]) == 3
        n_env = sum(k.startswith("env_") and k != "env_meta" for k in s2.files)
        assert n_env > 0
        for i in range(n_env):
            np.testing.assert_array_equal(s3[f"env_{i}"], s2[f"env_{i}"])
        # the floor's xyz: the first of the params, the last leaves
        xyz = n_env - len(PARAM_FIELDS)
        assert not np.array_equal(s3[f"floor_{xyz}"], s2[f"floor_{xyz}"])
    before = {p.name: p.stat().st_mtime_ns for p in ckpts.iterdir()}

    monkeypatch.setattr(tst.SceneTrainer, "scene_video_inference",
                        functools.partialmethod(tst.SceneTrainer.scene_video_inference,
                                                max_frames=1))
    rendered, render = [], tst.scene_render
    monkeypatch.setattr(tst, "scene_render",
                        lambda *a, **kw: rendered.append(1) or render(*a, **kw))
    assert cli.main(args + ["only_render=true"]) == 0
    assert {p.name: p.stat().st_mtime_ns for p in ckpts.iterdir()} == before
    assert len(rendered) == 1
    assert len(_video_files(exp / "vis", "render")) == 2

