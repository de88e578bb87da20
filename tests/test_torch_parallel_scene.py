"""SceneTrainer on a mesh: four CPU ranks over gloo (dp 2 x tp 2,
shard_splats) against the port's single-process SceneTrainer on the same
tiny scene (64x64, two placed objects, a tiny env and floor): one stage-1
step, then a one-camera recon step, which folds the mesh into one group of
four 16-row tile bands (test_parallel.py:279-312, :413). One spawn of
four ranks computes both (tests/torch_ranks.py::scene_trainer).

Tolerances: loss rtol 1e-3 / atol 1e-4, env and floor xyz atol 1e-4
(test_parallel.py:305-312); every rank holds the same models.
"""

import numpy as np
import pytest
import torch

from dreamscene_tpu_torch.parallel.launch import run_ranks
from dreamscene_tpu_torch.training.scene_trainer import SceneTrainer
from dreamscene_tpu_torch.utils.config import ParamsGroups as TCfg
from tests import torch_ranks
from tests.test_torch_scene_step import ENV_DENSITY, tiny_scene_cfg, write_objects

torch.set_num_threads(1)


def scene_cfg(dp=1, tp=1):
    cfg = tiny_scene_cfg(TCfg())
    cfg.sceneGenerateCamParams.image_w = cfg.sceneGenerateCamParams.image_h = 64
    cfg.parallelParams.dp, cfg.parallelParams.tp = dp, tp
    cfg.parallelParams.shard_splats = dp * tp > 1
    return cfg


def steps(tr, gt):
    """The stage-1 step and the recon step both runs take."""
    tr.prepare_train_scene()
    tr.iters, tr.step = 2, 0
    cams = tr._stage1_cams(tr.guidance_opt.C_batch_size)
    loss1 = tr.scene_train_step(cams, "env", only_env=False)
    env1, floor1 = tr.scene.env.params["xyz"].clone(), tr.scene.floor.params["xyz"].clone()
    loss3 = tr._run_scene_step(cams[:1], "floor", True, False, 1.0, guidance_on=False,
                               gt_images=[gt], optp=tr.cfg.reconSceneOptimizationParams)
    return dict(loss1=loss1, env1=env1, floor1=floor1, loss3=loss3,
                floor3=tr.scene.floor.params["xyz"], env3=tr.scene.env.params["xyz"])


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    gt = torch.from_numpy(np.random.default_rng(5).random((3, 64, 64)).astype(np.float32))
    for root in ("mesh", "single"):
        (d / root / "t" / "checkpoints").mkdir(parents=True)
        write_objects(d / root / "t" / "checkpoints")
    torch.save(dict(cfg=scene_cfg(2, 2), root=str(d / "mesh"), env_density=ENV_DENSITY, gt=gt),
               d / "inputs.pt")
    run_ranks(torch_ranks.scene_trainer, 4, (str(d),), device="cpu", store_dir=str(d),
              timeout_s=170)
    outs = [torch.load(d / f"out_{r}.pt", weights_only=False) for r in range(4)]
    tr = SceneTrainer(scene_cfg(), exp_root=str(d / "single"), device="cpu",
                      env_density=ENV_DENSITY)
    return steps(tr, gt), outs


def test_scene_mesh_stage1_step_matches_single_process(results):
    """dp 2 x tp 2 with shard_splats: each model's rows split over tp
    (a capacity that divides), the concatenated axis padded and projected
    in shards; the loss and the env / floor positions of the
    single-process step."""
    single, outs = results
    for o in outs:
        np.testing.assert_allclose(o["loss1"], single["loss1"], rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(o["env1"].numpy(), single["env1"].numpy(), atol=1e-4)
        np.testing.assert_allclose(o["floor1"].numpy(), single["floor1"].numpy(), atol=1e-4)
        assert torch.equal(o["env1"], outs[0]["env1"])
        for name, (rows, cap) in o["rows"].items():
            if cap is not None:
                assert rows * 2 == cap, (name, rows, cap)
    assert any(cap is not None for _, cap in outs[0]["rows"].values())


def test_scene_mesh_recon_step_folds_to_tile_bands(results):
    """A one-camera recon step cannot split over dp 2: it runs on one
    group of dp * tp = 4 tile bands, and moves the floor as the
    single-process step does; the env stays as it was."""
    single, outs = results
    for o in outs:
        assert o["flat"] == {"dp": 1, "tp": 4}
        np.testing.assert_allclose(o["loss3"], single["loss3"], rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(o["floor3"].numpy(), single["floor3"].numpy(), atol=1e-4)
        assert torch.equal(o["env3"], o["env1"])
        assert torch.equal(o["floor3"], outs[0]["floor3"])
