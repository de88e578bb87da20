"""A whole object training run on the card, the port's twin of
scripts/soak_object_train.py: 1,500 FPS iterations and 300 recon
iterations of a 50K-point `default` ball at SH 2, 512^2 and C_batch 4, with
densification every 100 steps from step 100, an opacity reset every 300, a
200K splat cap, the importance filter, and orbit videos, on the tiny SD
stack at SD's latent shapes (downscale 8), so that the time goes to the
pipeline: densify cadence, the capacity controller's grow and shrink,
opacity resets, filtering and video inference.

    python3 -m dreamscene_tpu_torch.bench.soak_object     # one CUDA card

Lengths as in the JAX script: SOAK_ITERS (1500), SOAK_RECON_ITERS (300),
SOAK_PTS (50000), SOAK_IMG (512); SOAK_EXP (build/soak_object_exp under
the checkout) is the experiment root, which must not hold an earlier run
(the trainer would resume it). Prints one JSON line: SOAK_r05.json's
fields (wall seconds, iterations per second, splat counts, every change
of the controller's multiplier with its step, the final splat extent, the
videos), the wall seconds by part, the densify calls, opacity resets and
filter passes that ran, the entries and drops of every step that reports
them (sum and maximum) and the distinct entry capacities the run rendered
at, and the card's `nvidia-smi` name and power limit.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from pathlib import Path

import torch

ITERS = int(os.environ.get("SOAK_ITERS", 1500))
RECON_ITERS = int(os.environ.get("SOAK_RECON_ITERS", 300))
N_PTS = int(os.environ.get("SOAK_PTS", 50_000))
IMG = int(os.environ.get("SOAK_IMG", 512))
EXP_ROOT = os.environ.get("SOAK_EXP",
                          str(Path(__file__).resolve().parents[2] / "build" / "soak_object_exp"))


def build_cfg(iters: int = ITERS, recon_iters: int = RECON_ITERS, n_pts: int = N_PTS,
              img: int = IMG):
    """The JAX script's configuration, knob for knob."""
    from dreamscene_tpu_torch.utils.config import ObjectsParamsGroups

    cfg = ObjectsParamsGroups()
    cfg.log = {"exp_name": "soak_object"}
    cfg.objectParams.id = "soak"
    cfg.objectParams.init_guided = "default"
    cfg.objectParams.num_pts = n_pts
    cfg.objectParams.sh_degree = 2
    cfg.objectParams.text = "a ceramic vase"
    cfg.optimizationParams.iterations = iters
    # reference-cadence densification, scaled to the run length
    cfg.optimizationParams.densify_from_iter = 100
    cfg.optimizationParams.densify_until_iter = iters
    cfg.optimizationParams.densification_interval = 100
    cfg.optimizationParams.opacity_reset_interval = 300
    cfg.optimizationParams.max_point_number = 200_000
    cfg.reconOptimizationParams.iterations = recon_iters
    cfg.guidanceParams.C_batch_size = 4
    cfg.generateCamParams.image_w = img
    cfg.generateCamParams.image_h = img
    cfg.mode_args = {}
    return cfg


def fresh_root(exp_root, exp_name: str) -> Path:
    """`exp_root`, refused when it holds the experiment already: a trainer
    resumes whatever it finds there, and the run would not be whole."""
    exp = Path(exp_root) / exp_name
    if exp.exists():
        raise FileExistsError(f"{exp} holds an earlier run: remove it or choose another root")
    return Path(exp_root)


class Recorder:
    """What a run did, counted where it happens: densify_and_prune,
    reset_opacity and importance_filter calls (the functions the trainers
    call, wrapped for the run), every step's entries and drops as the
    capacity controller is fed them, the multiplier's changes, the entry
    capacities asked for, and wall seconds by part."""

    def __init__(self, where):
        self.where = where                       # () -> label of the current step
        self.events = {"densify": [], "opacity_reset": [], "filter": []}
        self.steps = []                          # (n_entries, n_dropped) per step
        self.mult_changes = []                   # [where, new multiplier]
        self.mult0 = None                        # the multiplier before the first
        self.capacities = set()
        self.part_s = {}

    @contextlib.contextmanager
    def counting(self):
        """Wrap the trainers' densify, opacity reset and filter functions
        for the duration of the block."""
        from dreamscene_tpu_torch.models import densify as D
        from dreamscene_tpu_torch.training import object_trainer as OT
        from dreamscene_tpu_torch.training import scene_trainer as ST

        patches = [(D, "densify_and_prune", "densify"), (D, "reset_opacity", "opacity_reset"),
                   (OT, "importance_filter", "filter"), (ST, "importance_filter", "filter")]
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
        for mod, name, kind in patches:
            setattr(mod, name, self._counted(getattr(mod, name), kind))
        try:
            yield self
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    def _counted(self, fn, kind):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            self.events[kind].append(self.where())
            return fn(*a, **k)
        return wrapper

    def watch_controller(self, ctrl, capacity_of=None):
        """Record each update of `ctrl` (entries, drops; a change of the
        multiplier with its step) and, through `capacity_of()` read before
        the update (else every `ctrl.capacity` call), the capacities."""
        update = ctrl.update
        self.mult0 = float(ctrl.mult)

        def spy_update(n, n_entries, n_dropped):
            self.steps.append((int(n_entries), int(n_dropped)))
            if capacity_of is not None:
                self.capacities.add(int(capacity_of()))
            changed = update(n, n_entries, n_dropped)
            if changed:
                self.mult_changes.append([self.where(), float(ctrl.mult)])
            return changed
        ctrl.update = spy_update
        if capacity_of is None:
            capacity = ctrl.capacity

            def spy_capacity(n):
                c = capacity(n)
                self.capacities.add(int(c))
                return c
            ctrl.capacity = spy_capacity

    def time_parts(self, obj, names):
        """Sum the wall seconds of each of obj's methods `names`."""
        for name in names:
            fn = getattr(obj, name)

            @functools.wraps(fn)
            def timed(*a, _fn=fn, _name=name, **k):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    _sync()
                    self.part_s[_name] = self.part_s.get(_name, 0.0) + time.perf_counter() - t0
            setattr(obj, name, timed)

    def summary(self) -> dict:
        drops = [d for _, d in self.steps]
        mults = [m for _, m in self.mult_changes]
        return {
            "events": {k: len(v) for k, v in self.events.items()},
            "event_steps": self.events,
            "steps_reported": len(self.steps),
            "entries_max": max((e for e, _ in self.steps), default=0),
            "entries_dropped_sum": int(sum(drops)),
            "entries_dropped_max": int(max(drops, default=0)),
            "steps_with_drops": int(sum(d > 0 for d in drops)),
            "capacity_mult_changes": self.mult_changes,
            "capacity_mult_init": self.mult0,
            "capacity_mult_shrinks": int(sum(
                b < a for a, b in zip([self.mult0] + mults, mults))),
            "n_capacities": len(self.capacities),
            "capacities": sorted(self.capacities),
            "part_wall_s": self.part_s,
        }


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def smi_line(device) -> str:
    if torch.device(device).type != "cuda":
        return "cpu"
    from dreamscene_tpu_torch.bench.throughput import smi_line as smi

    return smi()


def run(cfg, exp_root=EXP_ROOT, device="cuda") -> dict:
    """train() on `cfg` as the JAX script runs it; returns the JSON line's
    fields."""
    from dreamscene_tpu_torch.guidance import mtsd
    from dreamscene_tpu_torch.models.gaussians import num_active
    from dreamscene_tpu_torch.training.object_trainer import ObjectTrainer

    root = fresh_root(exp_root, cfg.log["exp_name"])
    guidance = mtsd.make_tiny_guidance(cfg.guidanceParams, downscale=8, device=device)
    tr = ObjectTrainer(cfg, guidance=guidance, exp_root=str(root), device=device)
    rec = Recorder(lambda: tr.step)
    rec.watch_controller(tr.cap_ctrl)
    rec.time_parts(tr, ("prepare_train", "train_step", "refine_phase", "video_inference",
                        "save_model"))
    n0 = num_active(tr.state)
    with rec.counting():
        t0 = time.perf_counter()
        tr.train(make_videos=True)
        _sync()
        wall = time.perf_counter() - t0
    act = num_active(tr.state)
    xyz = tr.state.params["xyz"][:act].detach().cpu().numpy()
    iters = cfg.optimizationParams.iterations
    recon = cfg.reconOptimizationParams.iterations
    return {
        "metric": "object_training_soak",
        "iters": iters,
        "recon_iters": recon,
        "recon_steps": tr.rec_count,
        "n_splats_init": int(n0),
        "n_splats_final": int(act),
        "wall_s": wall,
        "iters_per_s": (iters + recon) / wall,
        "capacity_mult_final": float(tr.cap_ctrl.mult),
        **rec.summary(),
        "xyz_extent": [float(x) for x in (xyz.max(0) - xyz.min(0))],
        "videos": sorted(p.name for p in tr.vis_path.glob("video_*.mp4*")),
        "device": smi_line(device),
    }


def main():
    print(json.dumps(run(build_cfg())), flush=True)


if __name__ == "__main__":
    main()
