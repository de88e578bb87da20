"""Driver: a closed loop of `ObjectTrainer.train_step`, the object's guided
Formation Pattern Sampling step.

Set-up makes, from the seed, the guidance modules' weights (weights.py) and
the object's starting splats (scenes.object_ball), hands both to the
program's `ObjectTrainer`, and sets its step count and schedules to where a
run has them at `start_iteration` (SH degree raised every 500 steps, camera
ranges widened every `scale_up_cameras_iter` steps). It then runs
`warmup_steps` steps through the window's own call: the first `check_steps`
are recorded for the check (their inputs as `step_inputs` drew them, the
optimizer state after the first, the parameters after the last), then the
capacity controller is set to the entry demand those steps saw, as a run's
controller has settled by then.

The check runs the reference (`reference/fps.py`) over the recorded steps
from the same starting splats and weights, made again from the seed, and
compares each step's loss, the first gradient and the parameters' change
over the recorded steps, each by its worst leaf.

Traffic parameters: start_iteration, warmup_steps, check_steps, trace_steps.
"""

from __future__ import annotations

import copy
import gc
import math
import time

import torch

from benchmark import compare, scenes
from benchmark.drivers.common import (clone_inputs, fresh_opt, masked, program_guidance,
                                      reference_guidance, sub_seed)

ADAM_B1 = 0.9


def start_params(cfg: dict, seed: int, device) -> tuple[dict, int]:
    """The object's starting parameters from the seed, and its row count."""
    p = cfg["program"]
    o = cfg["object"]
    n = p["objectParams"]["num_pts"]
    rows = min(max(n * 4, 1 << 14), p["optimizationParams"]["max_point_number"])
    gen = scenes.generator(sub_seed(seed, "splats"), device)
    params = scenes.object_ball(n, rows, p["objectParams"]["sh_degree"], o["radius"], gen,
                                device, o["init_opacity"])
    return params, n


def half_batch(inp: dict) -> dict:
    """A step's inputs with the second half of its cameras left out."""
    c = len(inp["cams"])
    h = c // 2
    te = inp["text_emb"]
    out = dict(inp, cams=inp["cams"][:h], aug=inp["aug"][:h], noise=inp["noise"][:h],
               vae_eps=inp["vae_eps"][:h], shs_noise=inp["shs_noise"][:h],
               scale_noise=inp["scale_noise"][:h],
               text_emb=te.reshape(3, c, *te.shape[1:])[:, :h].reshape(-1, *te.shape[1:]))
    return out


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, workdir: str):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.workdir = workdir
        self.recorded: list = []
        self.program: dict = {}

    # ---------------------------------------------------------------- set-up
    def _program_config(self):
        from dreamscene_tpu_torch.utils.config import ObjectsParamsGroups, merge_into

        pcfg = merge_into(ObjectsParamsGroups(), copy.deepcopy(self.cfg["program"]))
        pcfg.seed = self.seed
        pcfg.guidanceParams.noise_seed = self.seed
        return pcfg

    def setup(self):
        from dreamscene_tpu_torch.models.gaussians import GaussianState, adam_init
        from dreamscene_tpu_torch.training import object_trainer as OT

        pcfg = self._program_config()
        guidance = program_guidance(self.cfg, self.seed, self.device, pcfg.guidanceParams)
        params, n = start_params(self.cfg, self.seed, self.device)
        rows = params["xyz"].shape[0]
        aux = dict(active=torch.arange(rows, device=self.device) < n,
                   max_radii2d=torch.zeros((rows,), device=self.device),
                   xyz_gradient_accum=torch.zeros((rows,), device=self.device),
                   denom=torch.zeros((rows,), device=self.device))
        state = GaussianState(params=params, aux=aux, opt=adam_init(params),
                              sh_degree=pcfg.objectParams.sh_degree, active_sh_degree=0,
                              spatial_lr_scale=self.cfg["object"]["spatial_lr_scale"])
        tr = OT.ObjectTrainer(pcfg, guidance=guidance, state=state, exp_root=self.workdir,
                              device=self.device)
        tr.prepare_train()
        self._advance(tr, OT, int(self.traffic["start_iteration"]) - 1)
        self.tr = tr
        p0 = {k: v.detach().clone() for k, v in tr.state.params.items()}
        n_check = int(self.traffic["check_steps"])
        raw = []
        orig = tr.step_inputs

        def recording():
            inp = orig()
            self.recorded.append(clone_inputs(inp))
            return inp

        tr.step_inputs = recording
        try:
            for i in range(n_check):
                loss = tr.train_step()
                raw.append(tr.last_stats["n_entries"] + tr.last_stats["n_dropped"])
                if i == 0:
                    g1 = {k: (v / (1 - ADAM_B1)).detach().clone()
                          for k, v in tr.state.opt.mu.items()}
                self.program.setdefault("losses", []).append(loss)
        finally:
            del tr.step_inputs
        self.program["grad1"] = g1
        self.program["change"] = {k: (tr.state.params[k] - p0[k]).detach().clone()
                                  for k in p0}
        # the controller as a run's has settled: the demand seen, padded
        ctrl = tr.cap_ctrl
        ctrl.mult = ctrl._quantize(max(raw) * ctrl.pad / max(tr._n_band, 1), tr._n_band)
        for _ in range(int(self.traffic["warmup_steps"]) - n_check):
            tr.train_step()

    @staticmethod
    def _advance(tr, OT, step: int):
        """Step count and schedules as a run has them after `step` steps."""
        optim = tr.optim
        for s in range(1, step + 1):
            if s % 500 == 0:
                tr.state = tr.state.one_up_sh_degree()
            if (not optim.use_progressive and s >= optim.progressive_view_iter
                    and s % optim.scale_up_cameras_iter == 0):
                OT.scale_up_camera_ranges(tr.pose_args, optim)
        tr.step = step

    # ---------------------------------------------------------------- window
    def window(self, seconds: float) -> dict:
        tr = self.tr
        steps, failed, rungs, entries, dropped = 0, 0, [], 0, 0
        t0 = time.perf_counter()
        while True:
            loss = tr.train_step()
            steps += 1
            failed += 0 if math.isfinite(loss) else 1
            st = tr.last_stats
            rungs.append(st["n_rungs"])
            entries += st["n_entries"]
            dropped += st["n_dropped"]
            if time.perf_counter() - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        return dict(attempted=steps, failed=failed, steps=steps, seconds=elapsed,
                    rungs=rungs, n_entries=entries, n_dropped=dropped)

    def traced(self, n: int):
        for _ in range(n):
            self.tr.train_step()

    def step_flops(self, rungs: list) -> float:
        """Model FLOPs of steps with these ladder lengths (counts/sd.py)."""
        from benchmark.counts import sd

        p = self.cfg["program"]
        c = p["guidanceParams"]["C_batch_size"]
        h, w = p["generateCamParams"]["image_h"], p["generateCamParams"]["image_w"]
        unet = sd.unet_flops(self.cfg, 3 * c, h, w)
        vae = sd.vae_encoder_flops(self.cfg, c, h, w, backward=True)
        return sum(unet * (r + 1) + vae for r in rungs)

    def release(self):
        self.tr = None
        gc.collect()

    # ----------------------------------------------------------------- check
    def reference_readings(self, lower: bool = False, fault: str | None = None) -> dict:
        """The reference's losses, first gradient and change over the
        recorded steps, from the seed's inputs. `lower`: the control (the
        rasterizer in bfloat16, the guidance's kernels rounded to fp8).
        `fault="half_batch"`: the reference put in the program's place with
        half of each step's cameras left out, the mean taken over the rest."""
        from benchmark.reference import fps as RF

        mods = reference_guidance(self.cfg, self.seed, self.device, fp8=lower)
        params, n = start_params(self.cfg, self.seed, self.device)
        p0 = {k: v.clone() for k, v in params.items()}
        active = torch.arange(params["xyz"].shape[0], device=self.device) < n
        opt = fresh_opt(params)
        losses, masses, grad1 = [], [], None
        for inp in self.recorded:
            if fault == "half_batch":
                inp = half_batch(inp)
            loss, grads, params, opt, mass = RF.fps_step(params, opt, active, mods, inp, lower)
            losses.append(float(loss))
            masses.append(mass)
            if grad1 is None:
                grad1 = masked(grads, active)
        del mods
        return dict(losses=losses, masses=masses, grad1=grad1,
                    change={k: params[k] - p0[k] for k in p0})

    def judge(self, cand: dict, ref: dict, limits: dict) -> dict:
        return compare.training(cand, ref, limits)

    def check(self, limits: dict) -> dict:
        """The program's readings against the reference's, each number beside
        its limit."""
        return self.judge(self.program, self.reference_readings(), limits)
