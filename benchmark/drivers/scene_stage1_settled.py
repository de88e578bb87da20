"""Driver: the outdoor scene's stage-1 step as `scene_stage1` runs it (a
closed loop of `scene_train_step(cameras, "env", only_env=True)` over the
`_stage1_cams` pool), with the capacity controller settled before the
window, every step's rows counted, and the env and floor checked from the
seed.

Set-up is `scene_stage1.Cell`'s. The models' state before the first step is
kept as the program made it (`self.start`). After the `check_steps`
recorded steps the controller is set to the entry demand those steps saw,
padded, as `object_fps` sets it: a run's controller has shrunk by then, and
left alone it would shrink after 50 steps that fit, inside the window at a
step that depends on the seed. Every step, warm-up and window, must
concatenate the floor's and env's capacities (`last_stats["n_rows"]`; a
program that does not report it is not asked). The window prints one
`{"scene_window": ...}` line on stderr: the multiplier at its start and
end, the rows, whether the program reported them, the steps and the mean
rungs.

The check is `scene_stage1`'s (loss, first gradient and change of the
recorded steps against `reference/scene.scene_step`) and two numbers of the
initialization against `reference/scene_init.py`:
  init_xyz_gap    the largest |xyz_p - xyz_r| over the floor's and env's
                  rows, over the box's circumradius (inf where the row
                  counts differ);
  init_scale_gap  the largest |log-scale_p - log-scale_r| over a seeded
                  sample of `init_sample` rows of each model, the
                  reference's by exact search over all of the model's rows.

Faults (`faults`, for readings.py): "unchanged", the reference stepping a
state it never updates; "half_batch", the reference given the first half of
each recorded step's cameras (their backgrounds, noise, VAE draws and text
rows), the mean taken over those.

Traffic parameters: those of scene_stage1, init_sample, faults.
"""

from __future__ import annotations

import json
import sys

import torch

from benchmark import compare, scenes
from benchmark.drivers import scene_stage1
from benchmark.drivers.common import reference_guidance, sub_seed

NAMES = scene_stage1.NAMES


def half_batch(inp: dict) -> dict:
    """A recorded step's inputs with the second half of its cameras left out."""
    c = len(inp["cams"])
    h = c // 2
    te = inp["text_emb"]
    return dict(inp, cams=inp["cams"][:h], bg_rows=inp["bg_rows"][:h], noise=inp["noise"][:h],
                vae_eps=inp["vae_eps"][:h], gt_images=inp["gt_images"][:h],
                text_emb=te.reshape(3, c, *te.shape[1:])[:, :h].reshape(-1, *te.shape[1:]))


class Cell(scene_stage1.Cell):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, workdir: str):
        super().__init__(cfg, traffic, seed, device, workdir)
        self.demand: list = []
        self.rows = None
        self._raster_ops = None

    def setup(self):
        super().setup()
        self.program["init"] = self._program_init()

    def _samples(self) -> dict:
        """The seeded rows of each model whose scales are checked."""
        gen = scenes.generator(sub_seed(self.seed, "splats"), "cpu")
        k = int(self.traffic["init_sample"])
        out = {}
        for name in NAMES:
            n = int(self.start[name]["active"].sum())
            out[name] = torch.randperm(n, generator=gen)[:k]
        return out

    def _program_init(self) -> dict:
        out = {}
        for name, rows in self._samples().items():
            m = self.start[name]
            n = int(m["active"].sum())
            out[name] = {"xyz": m["params"]["xyz"][:n].double(),
                         "log_scale": m["params"]["scaling"][rows.to(self.device), 0].double()}
        return out

    def _settle(self):
        """The controller as a run's has settled: the demand seen, padded."""
        ctrl = self.tr.cap_ctrl
        n = self.rows // 2
        ctrl.mult = ctrl._quantize(max(self.demand) * ctrl.pad / max(n, 1), n)

    def _step(self) -> float:
        if self.rows is None:
            self.rows = self.tr.scene.floor.capacity + self.tr.scene.env.capacity
        if len(self.demand) == int(self.traffic["check_steps"]):
            self._settle()
        loss = super()._step()
        st = self.tr.last_stats
        self.demand.append(st["n_entries"] + st["n_dropped"])
        if "n_rows" in st and st["n_rows"] != self.rows:
            raise AssertionError(f"step {self.tr.step} concatenated {st['n_rows']} rows, "
                                 f"not the floor's and env's {self.rows}")
        return loss

    def window(self, seconds: float) -> dict:
        m0 = self.tr.cap_ctrl.mult
        w = super().window(seconds)
        print(json.dumps({"scene_window": {
            "mult_start": m0, "mult_end": self.tr.cap_ctrl.mult, "n_rows": self.rows,
            "n_rows_reported": "n_rows" in self.tr.last_stats, "steps": w["steps"],
            "mean_rungs": sum(w["rungs"]) / len(w["rungs"])}}), file=sys.stderr)
        return w

    # -------------------------------------------------------------- counts
    def step_flops(self, rungs: list) -> float:
        """Model FLOPs of steps with these ladder lengths: the UNet passes
        and the VAE encoder's forward and backward (counts/sd.py), and the
        rasterizer's counted work of one step (`raster_ops`)."""
        from benchmark.counts import sd

        p = self.cfg["program"]
        c = p["guidanceParams"]["C_batch_size"]
        h, w = p["sceneGenerateCamParams"]["image_h"], p["sceneGenerateCamParams"]["image_w"]
        unet = sd.unet_flops(self.cfg, 3 * c, h, w)
        vae = sd.vae_encoder_flops(self.cfg, c, h, w, backward=True)
        return sum(unet * (r + 1) + vae + self.raster_ops() for r in rungs)

    def raster_ops(self) -> float:
        """The rasterizer's counted operations (counts/raster.py) over the
        cameras of the last step taken, from the models as they stand:
        projection and SH over each view's visible rows, forward and
        backward, and K1 and K2 over its evaluated pairs."""
        if self._raster_ops is not None:
            return self._raster_ops
        from benchmark.counts import raster as CR
        from benchmark.reference import scene as RSC
        from benchmark.reference.projection import project_gaussians
        from dreamscene_tpu_torch.ops import binning
        from dreamscene_tpu_torch.training.object_trainer import camera_tensors

        tr = self.tr
        states = [tr.scene.floor, tr.scene.env]
        deg = min(s.active_sh_degree for s in states)
        with torch.no_grad():
            f, active = RSC.concat([s.params for s in states], [s.aux["active"] for s in states])
            n_pool = max(len(self.cams) // self.c, 1)
            k = (self.j - 1) % n_pool
            p = self.cfg["program"]["sceneGenerateCamParams"]
            width, height = p["image_w"], p["image_h"]
            ops = 0.0
            for cam in camera_tensors(self.cams[k * self.c:(k + 1) * self.c], self.device):
                s = project_gaussians(f["xyz"], f["scaling"], f["rotation"], f["opacities"],
                                      f["features"], cam["viewmatrix"], cam["projmatrix"],
                                      cam["campos"], cam["tanfovx"], cam["tanfovy"], width,
                                      height, sh_degree=deg, valid_mask=active)
                v = CR.view_counts(s, width, height, tr.last_stats["capacity"], 512,
                                   binning.DEFAULT_TILE_W, binning.DEFAULT_TILE_H)
                a = (v["live"], v["pairs"], v["live_chunks"], v["n_tiles"], v["tile_pix"])
                ops += (CR.k1(*a)["ops"] + CR.k2(*a)["ops"]
                        + CR.splat_ops(v["visible"], deg)["ops"])
        self._raster_ops = ops
        return ops

    # --------------------------------------------------------------- check
    def reference_readings(self, lower: bool = False, fault: str | None = None) -> dict:
        """The reference's readings (`scene_stage1`'s, and "init"). `lower`:
        the control, one precision down; `fault="unchanged"`: the
        reference stepping a state it never updates; `fault="half_batch"`:
        the reference over half of each step's cameras. Importing
        `scene_init` turns TF32 off for the reference's matmuls and
        convolutions before either runs."""
        from benchmark.reference import scene_init

        if fault is None:
            out = super().reference_readings(lower)
        elif fault == "unchanged":
            out = self._unchanged()
        elif fault == "half_batch":
            full = self.recorded
            self.recorded = [half_batch(inp) for inp in full]
            try:
                out = super().reference_readings()
            finally:
                self.recorded = full
        else:
            raise ValueError(f"unknown fault {fault!r}")
        s = self.cfg["program"]["scene_configs"]["scene"]
        out["init"] = scene_init.outdoor_init(
            s["radius"], bool(s.get("zero_ground", True)), self.seed,
            float(self.cfg.get("env_density", 1.0)), self._samples(), self.device, lower)
        return out

    def _unchanged(self) -> dict:
        from benchmark.reference import scene as RSC

        mods = reference_guidance(self.cfg, self.seed, self.device)
        order = list(self.start)
        models = [{k: self.start[n][k] for k in ("params", "opt", "active")} for n in order]
        losses, masses = [], []
        for inp in self.recorded:
            loss, _, _, mass = RSC.scene_step(models, inp["trainable"], mods, inp)
            losses.append(float(loss))
            masses.append(mass)
        zeros = {f"{n}.{k}": torch.zeros_like(v) for n, m in zip(order, models)
                 if self.key in (n, "all") for k, v in m["params"].items()}
        return dict(losses=losses, masses=masses, grad1=dict(zeros), change=dict(zeros))

    def judge(self, cand: dict, ref: dict, limits: dict) -> dict:
        out = compare.training(cand, ref, limits)
        c, r = cand["init"], ref["init"]
        xyz, scale = 0.0, 0.0
        for name in NAMES:
            if c[name]["xyz"].shape != r[name]["xyz"].shape:
                xyz = float("inf")
            else:
                xyz = max(xyz, float((c[name]["xyz"] - r[name]["xyz"]).abs().max())
                          / ref["init"]["radius"])
            scale = max(scale, float((c[name]["log_scale"] - r[name]["log_scale"]).abs().max()))
        out["init_xyz_gap"] = compare._entry(xyz, limits, "init_xyz_gap")
        out["init_scale_gap"] = compare._entry(scale, limits, "init_scale_gap")
        return out

