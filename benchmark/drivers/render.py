"""Driver: a closed loop of one forward and backward of the program's
`dreamscene_tpu_torch.ops.rasterizer.render`, gradients taken with respect
to the five splat tensors (bench.py's measurement).

Set-up draws the scene on the device from the seed (scenes.box_scene) and
places the orbit camera; the entry table has the configuration's capacity,
the one the capacity controller tracks for this view (1,425,000 for its
~1.29M raw entries: no entry drops), the same for every seed so that every
seed does the same work. The window renders the same view step after step,
with one synchronize at its end. The check renders the last step's inputs
with the reference (`reference/raster.py`) and compares the image, depth and
alpha and the five gradients.

Traffic parameters: warmup_steps, trace_steps.
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark import compare, scenes

PARAMS = ("means3d", "scales", "quats", "opacities", "shs")
OUTPUTS = ("image", "depth", "alpha")
def loss_of(out) -> torch.Tensor:
    return out["image"].mean() + 0.1 * out["depth"].mean() + 0.01 * out["alpha"].mean()


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, workdir: str):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.last = None
        self._counts = None

    def inputs(self):
        s = self.cfg["scene"]
        gen = scenes.generator(self.seed, self.device)
        scene = scenes.box_scene(s["n_splats"], s["sh_degree"], gen, self.device)
        c = self.cfg["camera"]
        cam = scenes.orbit_camera(c["width"], c["height"], c["radius"], c["theta"], c["phi"],
                                  c["fov"], self.device)
        return scene, cam

    def _render_args(self, cam, capacity):
        r = self.cfg["render"]
        return dict(**cam, bg=torch.zeros(3, device=self.device),
                    sh_degree=self.cfg["scene"]["sh_degree"], capacity=capacity,
                    chunk=r["chunk"], tile_w=r["tile_w"], tile_h=r["tile_h"])

    def setup(self):
        from dreamscene_tpu_torch.ops.rasterizer import render

        self.scene, self.cam = self.inputs()
        self.capacity = int(self.cfg["render"]["capacity"])
        args = self._render_args(self.cam, self.capacity)
        leaves = [self.scene[k].detach().requires_grad_(True) for k in PARAMS]

        def step():
            out = render(**dict(zip(PARAMS, leaves)), **args, device=self.device)
            grads = torch.autograd.grad(loss_of(out), leaves)
            return {**{k: out[k].detach() for k in OUTPUTS}, "n_dropped": out["n_dropped"],
                    "grads": dict(zip(PARAMS, grads))}

        self.step = step
        for _ in range(int(self.traffic["warmup_steps"])):
            self.last = step()

    def window(self, seconds: float) -> dict:
        steps = 0
        t0 = time.perf_counter()
        while True:
            self.last = self.step()
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        c = self.cfg["camera"]
        return dict(attempted=steps, failed=0, steps=steps, seconds=elapsed,
                    pixels_per_step=c["width"] * c["height"],
                    n_dropped_last=int(self.last["n_dropped"]))

    def traced(self, n: int):
        for _ in range(n):
            self.last = self.step()

    def view_counts(self) -> dict:
        """The view's live entries, pairs and chunks as the reference bins
        and composites it (counts/raster.py), computed once."""
        if self._counts is None:
            from benchmark.counts import raster as CR
            from benchmark.reference.projection import project_gaussians

            scene, cam = self.inputs()
            r = self.cfg["render"]
            with torch.no_grad():
                sp = project_gaussians(**scene, **{k: cam[k] for k in (
                    "viewmatrix", "projmatrix", "campos", "tanfovx", "tanfovy", "width",
                    "height")}, sh_degree=self.cfg["scene"]["sh_degree"])
            self._counts = CR.view_counts(sp, cam["width"], cam["height"], self.capacity,
                                          r["chunk"], r["tile_w"], r["tile_h"])
            self._counts["sh_degree"] = self.cfg["scene"]["sh_degree"]
        return self._counts

    def release(self):
        self.step = None
        self.scene = None
        gc.collect()

    def reference_readings(self, lower: bool = False) -> dict:
        """The reference's outputs and gradients for the same view;
        `lower`: the control, with the projected records and the outputs in
        bfloat16 (the precision below the configuration's float32)."""
        from benchmark.reference import raster as R
        from benchmark.reference.projection import project_gaussians

        scene, cam = self.inputs()
        r = self.cfg["render"]
        leaves = [scene[k].detach().requires_grad_(True) for k in PARAMS]
        p = dict(zip(PARAMS, leaves))
        sp = project_gaussians(p["means3d"], p["scales"], p["quats"], p["opacities"], p["shs"],
                               cam["viewmatrix"], cam["projmatrix"], cam["campos"],
                               cam["tanfovx"], cam["tanfovy"], cam["width"], cam["height"],
                               sh_degree=self.cfg["scene"]["sh_degree"])
        if lower:
            sp = sp._replace(**{k: getattr(sp, k).to(torch.bfloat16).float() for k in (
                "means2d", "depths", "conics", "colors", "opacities")})
        out = R.render_from_splats(sp, cam["width"], cam["height"],
                                   torch.zeros(3, device=self.device), capacity=self.capacity,
                                   chunk=r["chunk"], tile_w=r["tile_w"], tile_h=r["tile_h"])
        if lower:
            out = {**out, **{k: out[k].to(torch.bfloat16).float() for k in OUTPUTS}}
        grads = torch.autograd.grad(loss_of(out), leaves)
        if lower:
            grads = [g.to(torch.bfloat16).float() for g in grads]
        return {**{k: out[k].detach() for k in OUTPUTS}, "grads": dict(zip(PARAMS, grads))}

    def judge(self, cand: dict, ref: dict, limits: dict) -> dict:
        return compare.answers(cand, ref, OUTPUTS, limits)

    def check(self, limits: dict) -> dict:
        """The program's readings against the reference's, each number beside
        its limit."""
        return self.judge(self.last, self.reference_readings(), limits)
