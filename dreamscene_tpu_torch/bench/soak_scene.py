"""A whole three-stage indoor scene run on the card, the port's twin of
scripts/soak_scene_train.py: the object task (a 20K-point vase), its
compression and placement in a one-vase room, stage 1 (env) for
SOAK_SCENE_STAGE1 steps, stage 2 (floor) for STAGE1 - 300, stage 3 (the
pseudo-GT refine) for SOAK_SCENE_STAGE3 iterations, the final combine and
PLY, each stage checkpointed; then a second trainer on the same directory,
which must resume at stage 3 and train nothing. Tiny SD stack at SD's
latent shapes (downscale 8).

    python3 -m dreamscene_tpu_torch.bench.soak_scene      # one CUDA card

Lengths and sizes as in the JAX script: SOAK_SCENE_STAGE1 (400),
SOAK_SCENE_STAGE3 (3), SOAK_SCENE_OBJ_ITERS (150), SOAK_SCENE_IMG (512),
SOAK_SCENE_ENV_DENSITY (0.08: ~300K splats, BASELINE.json config #4's
scale), SOAK_SCENE_EXP (experiments; it must not hold an earlier run).
Prints one JSON line: SOAK_SCENE_r05.json's fields (wall seconds in total
and by stage, the resume stage and its wall seconds, splat counts, the
checkpoints), stage iterations per second, each model's splats when the
scene is assembled and, as in soak_object, the scene controller's changes, the
densify calls, opacity resets and filter passes that ran, every scene
step's entries and drops, the distinct entry capacities, the steps the
resumed trainer ran, and the card's `nvidia-smi` name and power limit.
"""

from __future__ import annotations

import copy
import json
import os
import time

from dreamscene_tpu_torch.bench.soak_object import Recorder, _sync, fresh_root, smi_line

STAGE1 = int(os.environ.get("SOAK_SCENE_STAGE1", 400))  # stage 2 = STAGE1 - 300
N_STAGE3 = int(os.environ.get("SOAK_SCENE_STAGE3", 3))
OBJ_ITERS = int(os.environ.get("SOAK_SCENE_OBJ_ITERS", 150))
IMG = int(os.environ.get("SOAK_SCENE_IMG", 512))
# 0.08 puts the concatenated scene at ~300K splats
ENV_DENSITY = float(os.environ.get("SOAK_SCENE_ENV_DENSITY", 0.08))
EXP_ROOT = os.environ.get("SOAK_SCENE_EXP", "experiments")


def build_cfg(stage1: int = STAGE1, obj_iters: int = OBJ_ITERS, img: int = IMG):
    """The JAX script's configuration, knob for knob."""
    from dreamscene_tpu_torch.utils.config import ParamsGroups

    cfg = ParamsGroups()
    cfg.log = {"exp_name": "soak_scene"}
    cfg.optimizationParams.iterations = obj_iters
    cfg.optimizationParams.densify_from_iter = 50
    cfg.optimizationParams.densification_interval = 50
    cfg.optimizationParams.opacity_reset_interval = 10**9
    cfg.optimizationParams.max_point_number = 60_000
    cfg.reconOptimizationParams.iterations = 20
    cfg.sceneOptimizationParams.iterations = stage1
    # reference-cadence scene densification, scaled to the run length
    cfg.sceneOptimizationParams.densify_from_iter = 100
    cfg.sceneOptimizationParams.densification_interval = 100
    cfg.sceneOptimizationParams.opacity_reset_interval = 10**9
    cfg.guidanceParams.C_batch_size = 4
    cfg.guidanceParams.vis_interval = 10**9
    cfg.generateCamParams.image_w = img
    cfg.generateCamParams.image_h = img
    cfg.sceneGenerateCamParams.image_w = img
    cfg.sceneGenerateCamParams.image_h = img
    cfg.mode_args = {}
    cfg.scene_configs = {
        "objects": [
            {"id": "vase", "sh_degree": 2, "text": "a ceramic vase",
             "negative_text": "", "init_guided": "default",
             "num_pts": 20_000, "radius": 0.4},
        ],
        "scene": {
            "scene_name": "soak_room",
            "compress_n_views": 8,
            "sh_degree": 2,
            "cam_pose_method": "indoor",
            "scene_text": "a cozy room",
            "negative_text": "",
            "zero_ground": True,
            "floor_init_color": [240, 240, 244],
            "env_init_color": [200, 180, 160],
            "radius": [3.5, 2.5, 5.0],
            "scene_composition": [
                {"id": "vase", "params": [
                    {"center": [-1.0, 1.0, 0.0],
                     "rotation": [0.0, 0.0, 0.0],
                     "scale": [1.5, 1.5, 1.5]},
                ]},
            ],
        },
    }
    return cfg


def run(cfg, exp_root=EXP_ROOT, n_stage3: int = N_STAGE3, env_density: float = ENV_DENSITY,
        device="cuda") -> dict:
    """train(n_stage3, make_videos=False) on `cfg`, then the resumed
    trainer; returns the JSON line's fields."""
    from dreamscene_tpu_torch.guidance import mtsd
    from dreamscene_tpu_torch.models.gaussians import num_active
    from dreamscene_tpu_torch.training.scene_trainer import SceneTrainer

    root = str(fresh_root(exp_root, cfg.log["exp_name"]))
    cfg2 = copy.deepcopy(cfg)                     # the resumed trainer's, untouched
    guidance = mtsd.make_tiny_guidance(cfg.guidanceParams, downscale=8, device=device)
    tr = SceneTrainer(cfg, guidance=guidance, exp_root=root, device=device,
                      env_density=env_density)
    phase = ["objects"]

    def where():
        return phase[0] if phase[0] != "scene" else f"stage{tr.scene.stage_n + 1}:{tr.step}"

    rec = Recorder(where)
    rec.watch_controller(tr.cap_ctrl, capacity_of=lambda: tr.last_stats["capacity"])
    prepare = tr.prepare_train_scene
    n_init = {}

    def prepare_scene():
        phase[0] = "prepare"
        out = prepare()
        phase[0] = "scene"
        n_init.update(env=num_active(tr.scene.env), floor=num_active(tr.scene.floor),
                      objects={k: num_active(o.state) for k, o in tr.scene.objects.items()})
        return out
    tr.prepare_train_scene = prepare_scene
    rec.time_parts(tr, ("object_task", "prepare_train_scene", "scene_refine_phase",
                        "save_ckpt"))
    # each stage's wall seconds, to its checkpoint, as the JAX script takes them
    stage_s, last = {}, [time.perf_counter()]
    save = tr.save_ckpt

    def timed_save():
        _sync()
        stage_s[f"stage{tr.scene.stage_n}_s"] = time.perf_counter() - last[0]
        out = save()
        last[0] = time.perf_counter()
        return out
    tr.save_ckpt = timed_save

    with rec.counting():
        t0 = time.perf_counter()
        combined = tr.train(n_stage3=n_stage3, make_videos=False)
        _sync()
        wall = time.perf_counter() - t0

    # stage-checkpoint resume: a fresh trainer fast-forwards to stage 3 and
    # trains nothing
    tr2 = SceneTrainer(cfg2, guidance=guidance, exp_root=root, device=device,
                       env_density=env_density)
    resumed_steps = [0]
    step2 = tr2._run_scene_step

    def counted_step(*a, **k):
        resumed_steps[0] += 1
        return step2(*a, **k)
    tr2._run_scene_step = counted_step
    t1 = time.perf_counter()
    tr2.train(n_stage3=n_stage3, make_videos=False)
    _sync()
    resume_wall = time.perf_counter() - t1

    stage1 = cfg.sceneOptimizationParams.iterations
    stage2 = max(stage1 - 300, 1)
    return {
        "metric": "scene_training_soak",
        "stage1_iters": stage1,
        "stage2_iters": stage2,
        "stage3_iters": n_stage3,
        "img": cfg.sceneGenerateCamParams.image_w,
        "env_density": env_density,
        "wall_s": wall,
        "iters_per_s": (stage1 + stage2 + n_stage3) / wall,
        "stage_wall_s": stage_s,
        "resume_stage_n": int(tr2.scene.stage_n),
        "resume_wall_s": resume_wall,
        "resume_scene_steps": resumed_steps[0],
        "n_splats_init": n_init,
        "n_env": int(num_active(tr.scene.env)),
        "n_floor": int(num_active(tr.scene.floor)),
        "n_objects": {k: int(num_active(o.state)) for k, o in tr.scene.objects.items()},
        "n_combined": int(num_active(combined)) if combined is not None else 0,
        "capacity_mult_final": float(tr.cap_ctrl.mult),
        **rec.summary(),
        "ckpts": sorted(p.name for p in tr.scene_ckpt_path.iterdir()),
        "device": smi_line(device),
    }


def main():
    print(json.dumps(run(build_cfg())), flush=True)


if __name__ == "__main__":
    main()
