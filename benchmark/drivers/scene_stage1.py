"""Driver: a closed loop of `SceneTrainer.scene_train_step(cameras, key, only_env)`
over the stage's camera pool (stage 1 of an outdoor scene: key "env",
`only_env`, the floor and env rendered alone, the env trained).

Set-up writes each scene object's finished model from the seed
(scenes.object_ball, saved where `object_task` loads it, so no object is
trained), runs the program's `object_task` and `prepare_train_scene` (the
env shell and floor disk at `env_density`), draws the stage's camera pool
(`_stage1_cams`), and sets the step count to `start_iteration` - 1. The first
`check_steps` steps are recorded: their inputs as `step_inputs` drew them,
the models' state before them (the program's own env and floor: the check
follows the program from its state), the optimizer state after the first and
the parameters after the last. Then the rest of the warm-up.

The check runs `reference/scene.scene_step` over the recorded steps from the
recorded state with the reference's guidance modules made from the seed, and
compares the losses, the first gradient and the change of the trained
model's leaves.

Traffic parameters: key, only_env, start_iteration, warmup_steps,
check_steps, trace_steps.
"""

from __future__ import annotations

import copy
import gc
import math
import time

import torch

from benchmark import compare, scenes
from benchmark.drivers.common import (clone_inputs, masked, program_guidance,
                                      reference_guidance, sub_seed)

NAMES = ("floor", "env")
ADAM_B1 = 0.9


def _model(st) -> dict:
    return {"params": {k: v.detach().clone() for k, v in st.params.items()},
            "opt": {"count": st.opt.count,
                    "mu": {k: v.detach().clone() for k, v in st.opt.mu.items()},
                    "nu": {k: v.detach().clone() for k, v in st.opt.nu.items()}},
            "active": st.aux["active"].clone(), "active_deg": st.active_sh_degree}


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, workdir: str):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.workdir = workdir
        self.program: dict = {}
        self.recorded: list = []

    def _write_objects(self, tr):
        from dreamscene_tpu_torch.models.gaussians import GaussianState, adam_init
        from dreamscene_tpu_torch.models.ply import save_splat_ply

        for i, obj in enumerate(tr.scene_objects):
            n = int(obj.get("num_pts", 20_000))
            deg = int(obj.get("sh_degree", 1))
            gen = scenes.generator(sub_seed(self.seed, "splats") + 16 * (i + 1), self.device)
            params = scenes.object_ball(n, n, deg, float(obj.get("radius", 0.5)), gen,
                                        self.device)
            aux = dict(active=torch.ones((n,), dtype=torch.bool, device=self.device),
                       max_radii2d=torch.zeros((n,), device=self.device),
                       xyz_gradient_accum=torch.zeros((n,), device=self.device),
                       denom=torch.zeros((n,), device=self.device))
            st = GaussianState(params=params, aux=aux, opt=adam_init(params), sh_degree=deg,
                               active_sh_degree=deg)
            save_splat_ply(str(tr.ckpt_path / f"{obj['id']}_final_model.ply"), st)

    def setup(self):
        from dreamscene_tpu_torch.training.scene_trainer import SceneTrainer
        from dreamscene_tpu_torch.utils.config import ParamsGroups, merge_into

        pcfg = merge_into(ParamsGroups(), copy.deepcopy(self.cfg["program"]))
        pcfg.seed = self.seed
        pcfg.guidanceParams.noise_seed = self.seed
        guidance = program_guidance(self.cfg, self.seed, self.device, pcfg.guidanceParams)
        tr = SceneTrainer(pcfg, guidance=guidance, exp_root=self.workdir, device=self.device,
                          env_density=float(self.cfg.get("env_density", 1.0)))
        self._write_objects(tr)
        for obj_cfg in tr.scene_objects:
            tr.object_task(obj_cfg)
        tr.prepare_train_scene()
        tr.iters = pcfg.sceneOptimizationParams.iterations
        self.c = pcfg.guidanceParams.C_batch_size
        self.cams = tr._stage1_cams(tr.iters * self.c)
        tr.step = int(self.traffic["start_iteration"]) - 1
        self.tr = tr
        self.key, self.only_env = self.traffic["key"], bool(self.traffic["only_env"])
        self.j = 0
        names = tr._visible_names(self.only_env)
        self.start = {n: _model(st) for n, st in zip(list(names) + list(NAMES),
                                                     tr._states(names))}
        orig = tr.step_inputs

        def recording(*a, **kw):
            out = orig(*a, **kw)
            args = {k: v for k, v in out["args"].items() if k not in ("states", "mods")}
            args["active_deg"] = min(st.active_sh_degree for st in out["args"]["states"])
            args["trainable"] = out["args"]["trainable"]
            self.recorded.append(clone_inputs(args))
            return out

        n_check = int(self.traffic["check_steps"])
        tr.step_inputs = recording
        try:
            for i in range(n_check):
                self.program.setdefault("losses", []).append(self._step())
                if i == 0:
                    self.program["grad1"] = self._trained(
                        lambda n, st, k: st.opt.mu[k] / (1 - ADAM_B1))
        finally:
            del tr.step_inputs
        self.program["change"] = self._trained(
            lambda n, st, k: st.params[k] - self.start[n]["params"][k])
        for _ in range(int(self.traffic["warmup_steps"]) - n_check):
            self._step()

    def _trained(self, leaf) -> dict:
        """{"<model>.<leaf>": leaf(model name, state, leaf name)} over the
        models the key trains."""
        return {f"{n}.{k}": leaf(n, getattr(self.tr.scene, n), k).detach().clone()
                for n in NAMES if self.key in (n, "all")
                for k in getattr(self.tr.scene, n).params}

    def _step(self) -> float:
        n_pool = max(len(self.cams) // self.c, 1)
        k = self.j % n_pool
        self.j += 1
        return self.tr.scene_train_step(self.cams[k * self.c:(k + 1) * self.c], self.key,
                                        only_env=self.only_env)

    def window(self, seconds: float) -> dict:
        steps, failed, entries, dropped, rungs = 0, 0, 0, 0, []
        t0 = time.perf_counter()
        while True:
            loss = self._step()
            steps += 1
            failed += 0 if math.isfinite(loss) else 1
            st = self.tr.last_stats
            entries += st["n_entries"]
            dropped += st["n_dropped"]
            rungs.append(st["n_rungs"])
            if time.perf_counter() - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return dict(attempted=steps, failed=failed, steps=steps,
                    seconds=time.perf_counter() - t0, n_entries=entries, n_dropped=dropped,
                    rungs=rungs)

    def traced(self, n: int):
        for _ in range(n):
            self._step()

    def release(self):
        self.tr = None
        gc.collect()

    def reference_readings(self, lower: bool = False) -> dict:
        from benchmark.reference import scene as RSC

        mods = reference_guidance(self.cfg, self.seed, self.device, fp8=lower)
        order = list(self.start)
        models = [{k: self.start[n][k] for k in ("params", "opt", "active")} for n in order]
        losses, masses, grad1 = [], [], None
        for inp in self.recorded:
            loss, grads, models, mass = RSC.scene_step(models, inp["trainable"], mods, inp,
                                                       lower)
            losses.append(float(loss))
            masses.append(mass)
            if grad1 is None:
                grad1 = {f"{n}.{k}": v for n, g, m in zip(order, grads, models)
                         if g is not None for k, v in masked(g, m["active"]).items()}
        change = {f"{n}.{k}": m["params"][k] - self.start[n]["params"][k]
                  for n, m in zip(order, models) if self.key in (n, "all")
                  for k in m["params"]}
        return dict(losses=losses, masses=masses, grad1=grad1, change=change)

    def judge(self, cand: dict, ref: dict, limits: dict) -> dict:
        return compare.training(cand, ref, limits)

    def check(self, limits: dict) -> dict:
        """The program's readings against the reference's, each number beside
        its limit."""
        return self.judge(self.program, self.reference_readings(), limits)
