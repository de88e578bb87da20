"""The soak twins (bench/soak_object.py, bench/soak_scene.py): their configs
set the JAX scripts' knobs (scripts/soak_object_train.py,
scripts/soak_scene_train.py, read here, never run), and a tiny CPU run of
each prints every field its JSON line promises and counts the events its
config implies: densify calls, opacity resets and filter passes at their
steps, the drops of every step, and a second scene trainer that resumes at
stage 3 and runs no step.
"""

import ast
import dataclasses
import json
import os
from pathlib import Path

import pytest
import torch

from dreamscene_tpu.utils import config as JC
from dreamscene_tpu_torch.bench import soak_object as SO
from dreamscene_tpu_torch.bench import soak_scene as SS
from dreamscene_tpu_torch.cameras import sampling as TS
from dreamscene_tpu_torch.training import object_trainer as TOT

torch.set_num_threads(1)

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
COMMON_FIELDS = ("events", "event_steps", "steps_reported", "entries_max",
                 "entries_dropped_sum", "entries_dropped_max", "steps_with_drops",
                 "capacity_mult_init", "capacity_mult_changes", "capacity_mult_shrinks",
                 "capacity_mult_final", "n_capacities", "capacities", "part_wall_s", "wall_s",
                 "device")
OBJECT_FIELDS = ("metric", "iters", "recon_iters", "recon_steps", "n_splats_init",
                 "n_splats_final", "iters_per_s", "xyz_extent", "videos") + COMMON_FIELDS
SCENE_FIELDS = ("metric", "stage1_iters", "stage2_iters", "stage3_iters", "img", "env_density",
                "iters_per_s", "n_splats_init", "stage_wall_s", "resume_stage_n", "resume_wall_s", "resume_scene_steps",
                "n_env", "n_floor", "n_objects", "n_combined", "ckpts") + COMMON_FIELDS


def script_namespace(name):
    """The JAX script's module-level constants (its defaults, from the
    environment as it reads them) and its function definitions, executed
    from its source without running it."""
    tree = ast.parse((SCRIPTS / name).read_text())
    keep = [n for n in tree.body if isinstance(n, (ast.Assign, ast.FunctionDef))
            and not (isinstance(n, ast.FunctionDef) and n.name == "main")]
    ns = {"os": os}
    exec(compile(ast.Module(body=keep, type_ignores=[]), name, "exec"), ns)
    return ns, tree


def jax_object_cfg():
    """The config statements of soak_object_train.main (`cfg = ...` and
    `cfg.<group>.<knob> = ...`) on the JAX package's config."""
    ns, tree = script_namespace("soak_object_train.py")
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")

    def on_cfg(stmt):
        if not isinstance(stmt, ast.Assign):
            return False
        node = stmt.targets[0]
        while isinstance(node, ast.Attribute):
            node = node.value
        return isinstance(node, ast.Name) and node.id == "cfg"

    body = [s for s in main.body if on_cfg(s)]
    assert len(body) > 10
    ns["ObjectsParamsGroups"] = JC.ObjectsParamsGroups
    exec(compile(ast.Module(body=body, type_ignores=[]), "soak_object_train.py", "exec"), ns)
    return ns["cfg"]


def assert_same_cfg(jcfg, tcfg):
    jd, td = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    assert set(jd) <= set(td), set(jd) - set(td)
    for group, jv in jd.items():
        tv = td[group]
        if isinstance(jv, dict) and isinstance(tv, dict) and dataclasses.is_dataclass(
                getattr(jcfg, group)):
            for knob, v in jv.items():
                assert knob in tv and tv[knob] == v, (group, knob, v, tv.get(knob))
        else:
            assert tv == jv, (group, jv, tv)


def test_object_cfg_sets_the_jax_scripts_knobs():
    ns, _ = script_namespace("soak_object_train.py")
    assert (SO.ITERS, SO.N_PTS, SO.IMG) == (ns["ITERS"], ns["N_PTS"], ns["IMG"])
    assert_same_cfg(jax_object_cfg(), SO.build_cfg())


def test_scene_cfg_sets_the_jax_scripts_knobs():
    ns, _ = script_namespace("soak_scene_train.py")
    for k in ("STAGE1", "N_STAGE3", "OBJ_ITERS", "IMG", "ENV_DENSITY", "EXP_ROOT"):
        assert getattr(SS, k) == ns[k], k
    assert_same_cfg(ns["build_cfg"](), SS.build_cfg())


def tiny_object_cfg():
    cfg = SO.build_cfg(iters=24, recon_iters=1, n_pts=40, img=32)
    cfg.optimizationParams.densify_from_iter = 8
    cfg.optimizationParams.densification_interval = 8
    cfg.optimizationParams.opacity_reset_interval = 16
    cfg.optimizationParams.max_point_number = 4000
    cfg.guidanceParams.C_batch_size = 2
    return cfg


def test_tiny_object_soak_counts_its_events(tmp_path, monkeypatch, capsys):
    clip = TS.load_clip_cam
    monkeypatch.setattr(TOT.S, "load_clip_cam", lambda opt: clip(opt, size=3))
    res = SO.run(tiny_object_cfg(), exp_root=str(tmp_path), device="cpu")
    print(json.dumps(res))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line)["metric"] == "object_training_soak"
    assert all(k in res for k in OBJECT_FIELDS), set(OBJECT_FIELDS) - set(res)
    # densify at 8 and 16 (until the last step), a reset at 16, no filter
    assert res["event_steps"]["densify"] == [8, 16]
    assert res["event_steps"]["opacity_reset"] == [16]
    assert res["events"] == {"densify": 2, "opacity_reset": 1, "filter": 0}
    assert res["steps_reported"] == 24 and res["recon_steps"] == 18
    assert res["entries_dropped_sum"] == 0 and res["entries_max"] > 0
    assert res["n_splats_final"] > res["n_splats_init"] == 40
    assert res["n_capacities"] == len(res["capacities"]) >= 1
    assert len(res["videos"]) == 2 and res["device"] == "cpu"
    assert set(res["part_wall_s"]) >= {"train_step", "refine_phase", "video_inference"}
    # a second run into the same root is refused: the trainer would resume it
    with pytest.raises(FileExistsError):
        SO.run(tiny_object_cfg(), exp_root=str(tmp_path), device="cpu")


def test_tiny_scene_soak_resumes_at_stage_3(tmp_path):
    cfg = SS.build_cfg(stage1=4, obj_iters=2, img=32)
    cfg.sceneOptimizationParams.densify_from_iter = 2
    cfg.sceneOptimizationParams.densification_interval = 2
    cfg.optimizationParams.densify_from_iter = 1 << 30
    cfg.reconOptimizationParams.iterations = 1
    cfg.guidanceParams.C_batch_size = 2
    cfg.scene_configs["objects"][0]["num_pts"] = 40
    cfg.scene_configs["scene"]["compress_n_views"] = 4
    res = SS.run(cfg, exp_root=str(tmp_path), n_stage3=1, env_density=0.0002, device="cpu")
    json.dumps(res)
    assert all(k in res for k in SCENE_FIELDS), set(SCENE_FIELDS) - set(res)
    assert (res["stage1_iters"], res["stage2_iters"], res["stage3_iters"]) == (4, 1, 1)
    # stage-1 env densify at steps 2 and 4; the compression's filter pass
    assert res["event_steps"]["densify"] == ["stage1:2", "stage1:4"]
    assert res["event_steps"]["filter"] == ["prepare"]
    assert res["events"]["opacity_reset"] == 0
    # every scene step reports: 4 + 1 steps and one stage-3 iteration over the bank
    assert res["steps_reported"] > 5 and res["entries_dropped_sum"] == 0
    assert set(res["stage_wall_s"]) == {"stage1_s", "stage2_s", "stage3_s"}
    assert res["resume_stage_n"] == 3 and res["resume_scene_steps"] == 0
    assert res["ckpts"] == ["scene_1_stage.ckpt.npz", "scene_2_stage.ckpt.npz",
                            "scene_3_stage.ckpt.npz", "scene_final_model.ply"]
    assert res["n_combined"] == res["n_env"] + res["n_floor"] + sum(res["n_objects"].values())
    init = res["n_splats_init"]
    assert set(init["objects"]) == set(res["n_objects"]) and init["env"] > 0 and init["floor"] > 0
