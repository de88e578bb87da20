"""Scene training end to end in the port, on the CPU at a tiny size:
`SceneTrainer.train()` through the three stages to `scene_final_model.ply`
(which the JAX package's `load_splat_ply` reads) and its resume; stage
checkpoints that either package resumes from the other's; the outdoor
refine phase training the floor alone; the CLI's scene mode.

Tolerances: checkpoints restore bit-equal; the final PLY's active count
equals the combined model's; models that the outdoor refine does not train
stay bit-equal.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dreamscene_tpu.models import ply as JP
from dreamscene_tpu.models.gaussians import num_active as j_num_active
from dreamscene_tpu.training import scene_trainer as jst
from dreamscene_tpu.utils.config import ParamsGroups as JCfg
from dreamscene_tpu_torch.models.gaussians import PARAM_FIELDS, num_active
from dreamscene_tpu_torch.training import scene_trainer as tst
from dreamscene_tpu_torch.utils.config import ParamsGroups as TCfg
from tests.test_torch_scene_step import ENV_DENSITY, tiny_scene_cfg, write_objects

torch.set_num_threads(1)

AUX = ("active", "max_radii2d", "xyz_gradient_accum", "denom")


def trained_scene_cfg(cfg, method="indoor"):
    """The tiny scene with one object that object_task trains (2 FPS
    steps, 1 refine iteration) and places twice."""
    cfg = tiny_scene_cfg(cfg)
    cfg.optimizationParams.iterations = 2
    cfg.optimizationParams.densify_from_iter = 1 << 30
    cfg.reconOptimizationParams.iterations = 1
    cfg.sceneOptimizationParams.iterations = 2
    sc = cfg.scene_configs
    sc["objects"] = [{"id": "obj1", "sh_degree": 1, "text": "a chair", "negative_text": "",
                      "init_guided": "default", "num_pts": 30, "radius": 0.4}]
    sc["scene"].update(cam_pose_method=method, compress_objects=True, compress_n_views=4)
    sc["scene"]["scene_composition"] = [{"id": "obj1", "params": [
        {"center": [-1.0, 1.0, 0.0], "rotation": [0.0, 0.0, 0.0], "scale": [1.5, 1.5, 1.5]},
        {"center": [1.0, -1.0, 0.0], "rotation": [0.0, 0.0, 90.0], "scale": [1.0, 1.0, 1.0]}]}]
    return cfg


def test_train_end_to_end_then_resume_trains_nothing(tmp_path, monkeypatch):
    tr = tst.SceneTrainer(trained_scene_cfg(TCfg()), exp_root=str(tmp_path), device="cpu",
                          env_density=ENV_DENSITY)
    combined = tr.train(n_stage3=1)
    assert tr.scene.stage_n == 3 and len(tr.scene.objects) == 2
    assert (tr.ckpt_path / "obj1_final_model.ply").exists()
    assert (tr.ckpt_path / "obj1_final_model_compressed.ply").exists()
    for n in (1, 2, 3):
        assert (tr.scene_ckpt_path / f"scene_{n}_stage.ckpt.npz").exists()
    final = tr.scene_ckpt_path / "scene_final_model.ply"
    n_final = num_active(combined)
    assert n_final == sum(num_active(s) for s in tr._states(list(tr.scene.objects)))
    assert j_num_active(JP.load_splat_ply(str(final))) == n_final
    assert all(torch.isfinite(v).all() for v in combined.params.values())
    assert list(tr.exp_path.glob("layout.jpg*"))

    # a second run resumes at stage 3: no scene step runs, the PLY is rewritten
    def no_step(*a, **kw):
        raise AssertionError("a resumed stage-3 scene must not train")

    monkeypatch.setattr(tst, "scene_step", no_step)
    final.unlink()
    tr2 = tst.SceneTrainer(trained_scene_cfg(TCfg()), exp_root=str(tmp_path), device="cpu",
                           env_density=ENV_DENSITY)
    combined2 = tr2.train(n_stage3=1)
    assert tr2.scene.stage_n == 3 and final.exists()
    assert num_active(combined2) == n_final
    for f in PARAM_FIELDS:
        assert torch.equal(tr2.scene.env.params[f], tr.scene.env.params[f]), f


def _perturb_port(st, seed):
    g = torch.Generator().manual_seed(seed)
    for d in (st.params, st.opt.mu, st.opt.nu):
        for f in PARAM_FIELDS:
            d[f] = d[f] + torch.randn(d[f].shape, generator=g)
    st.aux["denom"] = st.aux["denom"] + 3.0
    st.aux["active"][:3] = False
    st.opt.count = 7
    return st


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, writer):
    """A stage checkpoint written by one package restores bit-equal in the
    other (env and floor: params, Adam moments and count, aux, active SH
    degree; the stage counter)."""
    from dreamscene_tpu.models import init as JI
    from dreamscene_tpu.models.gaussians import create_from_points
    from dreamscene_tpu.models.scene import SceneModel
    from dreamscene_tpu_torch import convert

    jtr = jst.SceneTrainer(tiny_scene_cfg(JCfg()), exp_root=str(tmp_path / "j"),
                           interpret=True, env_density=ENV_DENSITY)
    ttr = tst.SceneTrainer(tiny_scene_cfg(TCfg()), exp_root=str(tmp_path / "t"), device="cpu",
                           env_density=ENV_DENSITY)
    box = np.array([-3.5, -2.5, 0.0, 3.5, 2.5, 5.0], np.float32)
    env = JI.init_env_points("indoor", box, density=ENV_DENSITY)
    floor = JI.init_floor_points("indoor", box, seed=1, density=ENV_DENSITY)
    jtr.scene = SceneModel(env=create_from_points(*env, sh_degree=1, capacity=500),
                           floor=create_from_points(*floor, sh_degree=1, capacity=90),
                           scene_box=box)
    ttr.scene = convert.scene_model(jtr.scene)
    if writer == "jax":
        import dataclasses

        rng = np.random.RandomState(4)
        for name in ("env", "floor"):
            st = getattr(jtr.scene, name)
            p = dataclasses.replace(st.params, xyz=st.params.xyz + jnp.asarray(
                rng.randn(*st.params.xyz.shape).astype(np.float32)))
            opt = st.opt._replace(count=jnp.asarray(5, jnp.int32))
            setattr(jtr.scene, name, dataclasses.replace(st, params=p, opt=opt,
                                                         active_sh_degree=1))
        jtr.scene.stage_n = 2
        jtr.save_ckpt()
        src, dst = jtr, ttr
    else:
        ttr.scene.env = _perturb_port(ttr.scene.env, 1)
        ttr.scene.floor = _perturb_port(ttr.scene.floor, 2)
        ttr.scene.floor.active_sh_degree = 1
        ttr.scene.stage_n = 2
        ttr.save_ckpt()
        src, dst = ttr, jtr
    (dst.scene_ckpt_path / "scene_2_stage.ckpt.npz").write_bytes(
        (src.scene_ckpt_path / "scene_2_stage.ckpt.npz").read_bytes())
    dst._maybe_resume()
    assert jtr.scene.stage_n == ttr.scene.stage_n == 2
    for name in ("env", "floor"):
        j, t = getattr(jtr.scene, name), getattr(ttr.scene, name)
        assert t.active_sh_degree == j.active_sh_degree
        assert t.opt.count == int(j.opt.count) == (5 if writer == "jax" else 7)
        for f in PARAM_FIELDS:
            np.testing.assert_array_equal(t.params[f].numpy(), np.asarray(getattr(j.params, f)))
            np.testing.assert_array_equal(t.opt.mu[f].numpy(), np.asarray(getattr(j.opt.mu, f)))
            np.testing.assert_array_equal(t.opt.nu[f].numpy(), np.asarray(getattr(j.opt.nu, f)))
        for f in AUX:
            np.testing.assert_array_equal(t.aux[f].numpy(), np.asarray(getattr(j.aux, f)))
        assert t.aux["active"].dtype == torch.bool


def test_outdoor_refine_optimizes_floor_only(tmp_path):
    """Outdoor stage 3 (after tests/test_trainers.py's JAX case): key
    "floor" on every iteration, so the floor trains against its pseudo-GT
    bank while the env and the objects stay bit-equal."""
    cfg = tiny_scene_cfg(TCfg())
    cfg.scene_configs["scene"]["cam_pose_method"] = "outdoor"
    tr = tst.SceneTrainer(cfg, exp_root=str(tmp_path), device="cpu", env_density=ENV_DENSITY)
    write_objects(tr.ckpt_path)
    tr.prepare_train_scene()
    tr.scene.stage_n = 2
    tr.step = 0
    tr.scene_cams = tr._stage3_cams(2 * tr.guidance_opt.C_batch_size)
    tr.gt_size = len(tr.scene_cams) // 4 * 4
    assert tr.gt_size >= 4
    tr.n_stage3 = 1
    env0 = tr.scene.env.params["xyz"].clone()
    floor0 = tr.scene.floor.params["xyz"].clone()
    obj0 = {n: e.state.params["xyz"].clone() for n, e in tr.scene.objects.items()}
    tr.scene_refine_phase(only_env=True, scene_optim=False)
    assert torch.equal(tr.scene.env.params["xyz"], env0)
    assert not torch.allclose(tr.scene.floor.params["xyz"], floor0)
    assert tr.scene.floor.opt.count == tr.gt_size
    for n, e in tr.scene.objects.items():
        assert torch.equal(e.state.params["xyz"], obj0[n])


def test_cli_scene_mode(tmp_path, monkeypatch):
    """`python -m dreamscene_tpu_torch --config <scene yaml>` without
    --object runs SceneTrainer(cfg).train(), as main.py does. Run in
    process, with train()'s stage-3 iterations cut from 25 to 1; the
    config's three objects are written as finished PLYs first, so
    object_task loads them and compress_objects filters them."""
    from dreamscene_tpu_torch import __main__ as cli

    monkeypatch.setattr(tst.SceneTrainer, "train",
                        functools.partialmethod(tst.SceneTrainer.train, n_stage3=1))
    ckpt = tmp_path / "cli" / "checkpoints"
    ckpt.mkdir(parents=True)
    write_objects(ckpt, ("refrigerator", "cookers", "cabinets"))
    rc = cli.main([
        "--config", "configs/scenes/sample_indoor.yaml", "--device", "cpu",
        "--exp-root", str(tmp_path), "--env-density", str(ENV_DENSITY),
        "scene_configs.scene.compress_n_views=4", "sceneOptimizationParams.iterations=2",
        "guidanceParams.C_batch_size=2", "generateCamParams.image_w=32",
        "generateCamParams.image_h=32", "sceneGenerateCamParams.image_w=32",
        "sceneGenerateCamParams.image_h=32", "log.exp_name=cli"])
    assert rc == 0
    assert (ckpt / "cabinets_final_model_compressed.ply").exists()
    final = tmp_path / "cli" / "scene_checkpoints" / "scene_final_model.ply"
    assert final.exists()
    assert j_num_active(JP.load_splat_ply(str(final))) > 0
