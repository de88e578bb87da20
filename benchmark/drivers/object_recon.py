"""Driver: a closed loop of the program's refine step,
`training/object_trainer.py::recon_step`, over the reco rig's first
`views` cameras (18 in a run: the rig's 36 views, half of them a batch),
against seeded targets.

Set-up makes the object from the seed (scenes.object_ball, the traffic's
`num_pts` splats: the size an object reaches by the end of its FPS steps), the targets
(smooth seeded images: a coarse uniform grid upsampled bilinearly), and the
cameras of the program's reco rig, with the refine's learning rates at its
first step. The entry capacity is `capacity_mult` x the rows (the
controller's starting 4 when absent), as the refine reads it from the
trainer's controller. The first `check_steps` steps are recorded. Each step
ends in a host read of its loss, as the refine's loop does.

The check runs `reference/scene.recon_step` over the recorded steps from the
same object and targets, made again from the seed, and compares the losses,
the first gradient and the change, by the worst leaf.

Traffic parameters: views, num_pts, warmup_steps, check_steps, trace_steps,
capacity_mult.
"""

from __future__ import annotations

import copy
import gc
import math
import time

import torch
import torch.nn.functional as F

from benchmark import compare, scenes
from benchmark.drivers.common import fresh_opt, masked, sub_seed

class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, workdir: str):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.program: dict = {}
        self.recorded: list = []

    def inputs(self):
        """(raw parameters, active mask, targets [V, 3, H, W]) from the seed."""
        o = self.cfg["object"]
        p = self.cfg["program"]
        n = int(self.traffic.get("num_pts", p["objectParams"]["num_pts"]))
        rows = min(max(n * 4, 1 << 14), p["optimizationParams"]["max_point_number"])
        params = scenes.object_ball(n, rows, p["objectParams"]["sh_degree"], o["radius"],
                                    scenes.generator(sub_seed(self.seed, "splats"),
                                                     self.device), self.device,
                                    o["init_opacity"])
        h, w = p["generateCamParams"]["image_h"], p["generateCamParams"]["image_w"]
        gen = scenes.generator(sub_seed(self.seed, "vae_decoder"), self.device)
        coarse = torch.rand((self.traffic["views"], 3, 8, 8), generator=gen,
                            device=self.device)
        targets = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
        active = torch.arange(rows, device=self.device) < n
        return params, active, targets

    def setup(self):
        from dreamscene_tpu_torch.cameras import sampling as S
        from dreamscene_tpu_torch.models.gaussians import GaussianState, adam_init, group_lrs
        from dreamscene_tpu_torch.training import object_trainer as OT
        from dreamscene_tpu_torch.utils.config import ObjectsParamsGroups, merge_into

        pcfg = merge_into(ObjectsParamsGroups(), copy.deepcopy(self.cfg["program"]))
        params, active, self.targets = self.inputs()
        rows = params["xyz"].shape[0]
        aux = dict(active=active, max_radii2d=torch.zeros((rows,), device=self.device),
                   xyz_gradient_accum=torch.zeros((rows,), device=self.device),
                   denom=torch.zeros((rows,), device=self.device))
        o = self.cfg["object"]
        self.state = GaussianState(params=params, aux=aux, opt=adam_init(params),
                                   sh_degree=pcfg.objectParams.sh_degree,
                                   active_sh_degree=o.get("active_sh_degree", 0),
                                   spatial_lr_scale=o["spatial_lr_scale"])
        cams = S.load_reco_cam(pcfg.generateCamParams, (4, 12, 14, 6), (100, 85, 75, 55),
                               scale=0.9)[:self.traffic["views"]]
        self.cams = OT.camera_tensors(cams, self.device)
        step = pcfg.optimizationParams.iterations + 1
        self.lrs = group_lrs(pcfg.reconOptimizationParams, o["spatial_lr_scale"], step)
        self.h, self.w = pcfg.generateCamParams.image_h, pcfg.generateCamParams.image_w
        self.capacity = int(round(float(self.traffic.get("capacity_mult", 4.0)) * rows))
        self.recon_step = OT.recon_step
        self.i = 0
        p0 = {k: v.detach().clone() for k, v in params.items()}
        for j in range(int(self.traffic["check_steps"])):
            self.recorded.append(dict(view=self.i % len(self.cams), capacity=self.capacity,
                                      active_deg=self.state.active_sh_degree))
            res = self._step()
            self.program.setdefault("losses", []).append(res["loss"])
            if j == 0:
                self.program["grad1"] = masked({k: v.detach().clone()
                                                for k, v in res["grads"].items()}, active)
        self.program["change"] = {k: self.state.params[k] - p0[k] for k in p0}
        for _ in range(int(self.traffic["warmup_steps"]) - len(self.recorded)):
            self._step()

    def _step(self) -> dict:
        v = self.i % len(self.cams)
        self.i += 1
        st = self.state
        res = self.recon_step(st, self.cams[v], self.targets[v], self.lrs, width=self.w,
                              height=self.h, capacity=self.capacity,
                              active_deg=st.active_sh_degree)
        st.params, st.opt, st.aux = res["params"], res["opt"], res["aux"]
        return dict(loss=float(res["loss"]), grads=res["grads"])

    def window(self, seconds: float) -> dict:
        steps, failed = 0, 0
        t0 = time.perf_counter()
        while True:
            loss = self._step()["loss"]
            steps += 1
            failed += 0 if math.isfinite(loss) else 1
            if time.perf_counter() - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return dict(attempted=steps, failed=failed, steps=steps,
                    seconds=time.perf_counter() - t0)

    def traced(self, n: int):
        for _ in range(n):
            self._step()

    def release(self):
        self.state = None
        self.recon_step = None
        gc.collect()

    def reference_readings(self, lower: bool = False) -> dict:
        from benchmark.reference import scene as RSC

        params, active, targets = self.inputs()
        p0 = {k: v.clone() for k, v in params.items()}
        opt = fresh_opt(params)
        losses, grad1 = [], None
        for rec in self.recorded:
            loss, grads, params, opt = RSC.recon_step(
                params, opt, active, self.cams[rec["view"]], targets[rec["view"]], self.lrs,
                self.w, self.h, rec["capacity"], rec["active_deg"], lower)
            losses.append(float(loss))
            grad1 = grad1 or masked(grads, active)
        return dict(losses=losses, grad1=grad1, change={k: params[k] - p0[k] for k in p0})

    def judge(self, cand: dict, ref: dict, limits: dict) -> dict:
        return compare.training(cand, ref, limits)

    def check(self, limits: dict) -> dict:
        """The program's readings against the reference's, each number beside
        its limit."""
        return self.judge(self.program, self.reference_readings(), limits)
