"""The port's scene cameras (its own copy of cameras/scene_sampling.py)
against the JAX package's: the same seed gives the same cameras (R, T,
FoVs, sizes, view deltas, anchor and scale), bit for bit, in the same
number, for every SceneCameraLoader rig indoor and outdoor, and the same
`viewpoint_in_scene` verdicts. Both scene YAMLs load into equal configs.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from dreamscene_tpu.cameras import scene_sampling as JSS
from dreamscene_tpu.models.scene import ObjectArgs as JArgs
from dreamscene_tpu.utils.config import load_config as j_load_config
from dreamscene_tpu_torch.cameras import scene_sampling as TSS
from dreamscene_tpu_torch.models.scene import ObjectArgs as TArgs
from dreamscene_tpu_torch.utils.config import load_config as t_load_config

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
BOX = np.array([-3.5, -2.5, 0.0, 3.5, 2.5, 5.0], np.float32)
PLACED = [(np.array([-3.2, 1.6, 0.0, -2.4, 2.4, 1.8], np.float32),
           {"T": np.array([-3.0, 2.0, 0.0]), "R": np.zeros(3), "S": np.full(3, 2.0)}),
          (np.array([2.6, -2.4, 0.0, 3.4, -1.9, 0.9], np.float32),
           {"T": np.array([3.2, -2.2, 0.0]), "R": np.array([0, 0, 180.0]),
            "S": np.full(3, 1.2)})]


def configs(name):
    path = str(ROOT / "configs" / "scenes" / name)
    return t_load_config(path, [], object_mode=False), j_load_config(path, [], object_mode=False)


@pytest.mark.parametrize("name", ["sample_indoor.yaml", "sample_outdoor.yaml"])
def test_scene_configs_load_like_jax(name):
    t, j = configs(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def loaders(method, seed):
    t_cfg, j_cfg = configs(f"sample_{method}.yaml")
    t_args = [TArgs("o", i, aff, box) for i, (box, aff) in enumerate(PLACED)]
    j_args = [JArgs("o", i, aff, box) for i, (box, aff) in enumerate(PLACED)]
    return (TSS.SceneCameraLoader(np.random.default_rng(seed), t_cfg.sceneGenerateCamParams,
                                  BOX, t_args, method),
            JSS.SceneCameraLoader(np.random.default_rng(seed), j_cfg.sceneGenerateCamParams,
                                  BOX, j_args, method))


def assert_same_cameras(tcams, jcams):
    assert len(tcams) == len(jcams) > 0
    for t, j in zip(tcams, jcams):
        td, jd = dataclasses.asdict(t), dataclasses.asdict(j)
        assert td.keys() == jd.keys()
        for k in td:
            np.testing.assert_array_equal(np.asarray(td[k]), np.asarray(jd[k]), err_msg=k)
        np.testing.assert_array_equal(t.world_view_transform, j.world_view_transform)
        np.testing.assert_array_equal(t.full_proj_transform, j.full_proj_transform)


AFF = PLACED[0][1]
RIGS = {
    "indoor": [
        ("Stage1_Indoor", (), {}),
        ("Stage1_Indoor", (), {"size": 12, "view_floor": True}),
        ("Stage2_Indoor", (), {"affine_params": AFF}),
        ("Stage2_Indoor", (), {"idx": 3, "size": 12}),
        ("Circle", (), {"affine_params": AFF, "circle_size": 24}),
        ("Circle", (), {"circle_size": 24}),
        ("Circle2", (), {"start_phi": 30.0, "end_phi": 10.0, "circle_size": 36}),
        ("Circle3", (), {"circle_size": 24}),
        ("Line", ([-3.0, 0, 2.2], [1.5, 0.0, 2.2], 0.1), {}),
    ],
    "outdoor": [
        ("Stage1_Outdoor", (), {}),
        ("Stage1_Outdoor2", (), {}),
        ("Stage2_Outdoor", (), {}),
        ("Stage3_Outdoor", ("env",), {}),
        ("Stage3_Outdoor", ("floor",), {}),
        ("Circle", (), {"circle_size": 24}),
        ("Circle3", (), {"affine_params": AFF, "circle_size": 24}),
    ],
}


@pytest.mark.parametrize("method", ["indoor", "outdoor"])
def test_every_rig_matches_jax(method):
    """Every rig in turn from one generator per package, so each rig also
    leaves both generators in the same state."""
    tl, jl = loaders(method, seed=11)
    for name, args, kw in RIGS[method]:
        assert_same_cameras(getattr(tl, name)(*args, **kw), getattr(jl, name)(*args, **kw))
    assert tl.rng.random() == jl.rng.random()


def test_viewpoint_in_scene_and_scene_poses_match_jax():
    t_args = [TArgs("o", i, aff, box) for i, (box, aff) in enumerate(PLACED)]
    j_args = [JArgs("o", i, aff, box) for i, (box, aff) in enumerate(PLACED)]
    rng = np.random.RandomState(2)
    pts = rng.uniform(-4.5, 5.5, (200, 3))
    pts[:20] = rng.uniform(PLACED[0][0][:3], PLACED[0][0][3:], (20, 3))   # inside an object
    seen = set()
    for p in pts:
        for colli in (True, False):
            v = TSS.viewpoint_in_scene(p, BOX, t_args, colli)
            assert v == JSS.viewpoint_in_scene(p, BOX, j_args, colli)
            seen.add(v)
    assert seen == {0, 1, 2}
    t_cfg, j_cfg = configs("sample_indoor.yaml")
    t_rng, j_rng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(20):
        kw = dict(trans=np.array([0.0, 0.0, 2.5]), scale=1.0, scene_box=BOX,
                  cam_pose_method="indoor", radius_range=(1.5, 3.0), theta_range=(60, 110),
                  phi_range=(-180, 180), get_cam_outview_ratio=0.3)
        t = TSS.scene_poses(t_rng, t_cfg.sceneGenerateCamParams, objects_args=t_args, **kw)
        j = JSS.scene_poses(j_rng, j_cfg.sceneGenerateCamParams, objects_args=j_args, **kw)
        np.testing.assert_array_equal(t[0], j[0])
        assert t[1:] == j[1:]
