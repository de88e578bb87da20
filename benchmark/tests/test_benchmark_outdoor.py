"""The outdoor scene's cell, `outdoor_sd21.stage1_step`, on the CPU: its
driver (`drivers/scene_stage1_settled.py`) run through the harness at a
tiny size settles the capacity controller after the checked steps, counts
every step's rows and refuses a step that concatenates other rows; it runs
a program that does not report its rows too (the parent side of a
comparison); the cell's metric readers on a synthetic trace; the manifest
keeps its rules with the cell's entries; the half-batch fault reads above
the limits."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import manifest, run
from benchmark import trace as T
from benchmark.tests import tiny

torch.set_num_threads(2)
CELL = "outdoor_sd21.stage1_step"
# the cell's own readers, then the accepted ones it is listed under
OWN = ("scene_render_busy_ms", "scene_render_bwd_busy_ms", "scene_rows_busy_ms",
       "scene_guidance_busy_ms", "scene_guidance_bwd_busy_ms", "scene_adam_busy_ms")
SHARED = ("device_idle_pct.train", "entries_dropped_pct", "step_mfu", "unet_graph_pct",
          "k4_fwd_busy_ms", "peak_reserved_gib", "norm_kernel_pct")


def _run(trace: bool, warmup: int = 5):
    m = manifest.load()
    return run.run_cell(m, manifest.cell(m, CELL), 2**31 + 23, 0.2, trace, device="cpu",
                        cfg=tiny.outdoor_cfg(m),
                        traffic=tiny.traffic("stage1_env_settled", warmup_steps=warmup,
                                             init_sample=64))


def test_manifest_keeps_its_rules_with_the_cell():
    m = manifest.load()
    assert manifest.problems(m) == []
    reported = manifest.metrics_of(m, CELL)
    assert reported["end_to_end"] == ["step_ms", "peak_mem_gib", "setup_s"]
    assert sorted(reported["per_layer"]) == sorted(OWN + SHARED)
    assert manifest.cell(m, CELL)["chips"] == 1
    for name in OWN:
        assert manifest.metric_entry(m, name)["workloads"] == [CELL]
    for name in SHARED:
        assert manifest.metric_entry(m, name)["workloads"] == ["object_sd21.fps_step", CELL]


def test_driver_settles_the_controller_and_counts_rows(monkeypatch):
    from benchmark.drivers import scene_stage1_settled as D

    seen = {}
    settle = D.Cell._settle

    def spy(self):
        seen["before"] = self.tr.cap_ctrl.mult
        seen["steps"] = self.tr.step
        settle(self)
        seen["after"] = self.tr.cap_ctrl.mult

    monkeypatch.setattr(D.Cell, "_settle", spy)
    res = _run(False)
    assert res["correct"], res["checks"]
    assert seen["steps"] == 3 and seen["before"] == 4 and seen["after"] == 2
    assert set(res["checks"]) == {"loss_gap", "grad1_gap", "change_gap", "init_xyz_gap",
                                  "init_scale_gap"}
    assert res["metrics"]["step_ms"]["value"] > 0


def test_a_step_with_other_rows_is_refused(monkeypatch):
    from dreamscene_tpu_torch.training import scene_trainer as ST

    orig = ST.scene_step

    def short(**kw):
        res = orig(**kw)
        return dict(res, n_rows=res["n_rows"] - 1)

    monkeypatch.setattr(ST, "scene_step", short)
    with pytest.raises(AssertionError, match="concatenated"):
        _run(False, warmup=4)


def test_a_program_without_the_row_count_still_runs(monkeypatch):
    """The parent program reports no `n_rows` and opens no `scene.rows`:
    the cell runs, correct, and the rows metric reads nothing."""
    from dreamscene_tpu_torch.training import scene_trainer as ST

    orig = ST.SceneTrainer._run_scene_step

    def without(self, *a, **kw):
        loss = orig(self, *a, **kw)
        self.last_stats.pop("n_rows")
        return loss

    monkeypatch.setattr(ST.SceneTrainer, "_run_scene_step", without)
    res = _run(True, warmup=4)
    assert res["correct"], res["checks"]
    assert "scene_rows_busy_ms" not in res["metrics"]
    assert "step_mfu" in res["metrics"] and "entries_dropped_pct" in res["metrics"]


def test_the_half_batch_fault_reads_above_the_limits():
    from benchmark import readings

    m = manifest.load()
    out = readings.readings(m, manifest.cell(m, CELL), 2**31 + 23, 0.2, True, device="cpu",
                            cfg=tiny.outdoor_cfg(m),
                            traffic=tiny.traffic("stage1_env_settled", warmup_steps=4,
                                                 init_sample=64))
    limits = {k: v["limit"] for k, v in json.loads(manifest.limits_file(CELL).read_text()).items()
              if isinstance(v, dict)}
    assert all(out["program"][k] <= limits[k] for k in limits)
    fault = out["fault.half_batch"]
    assert fault["grad1_gap"] > limits["grad1_gap"] and fault["change_gap"] > limits["change_gap"]


# two steps of 1000 us (us): the rows, the render, its backward, the ladder
# with a replayed pass (its kernels correlate with the launch inside the
# range), the VAE encode and its backward, Adam
STEP = [(10, 20, "k_concat"), (30, 90, "k_render"), (100, 400, "k_ladder"),
        (400, 500, "k_replayed"), (520, 560, "k_vae"), (570, 590, "k_vae_bwd"),
        (600, 700, "k_render_bwd"), (800, 850, "k_adam")]
RANGES = {"scene.step": [(0, 900)], "scene.render": [(5, 95)], "scene.rows": [(5, 25)],
          "scene.vae_encode": [(515, 565)], "scene.ladder": [(95, 400)],
          "scene.vae_encode.bwd": [(565, 595)], "scene.render.bwd": [(595, 710)],
          "scene.adam": [(790, 860)]}


def _trace(with_rows: bool = True) -> T.Trace:
    busy = STEP + [(a + 1000, b + 1000, n) for a, b, n in STEP]
    ranges = {k: v + [(a + 1000, b + 1000) for a, b in v] for k, v in RANGES.items()
              if with_rows or k != "scene.rows"}
    return T.Trace(busy=busy, ranges=ranges, host=[], wall_s=0.002, n_steps=2)


class _Run:
    def step_flops(self, rungs):
        return 1e12 * len(rungs)


def _ctx(trace):
    return run.Context(trace=trace, run=_Run(), setup_s=1.0, peak_window_bytes=0,
                       window={"steps": 4, "seconds": 0.004, "rungs": [3, 4, 3, 4],
                               "n_entries": 990, "n_dropped": 10})


@pytest.mark.parametrize("name,value", [
    ("scene_render_busy_ms", 0.070), ("scene_render_bwd_busy_ms", 0.100),
    ("scene_rows_busy_ms", 0.010), ("scene_guidance_busy_ms", 0.300 + 0.040),
    ("scene_guidance_bwd_busy_ms", 0.020), ("scene_adam_busy_ms", 0.050),
    ("device_idle_pct.train", 100.0 * (1 - 0.68 / 1.0)),
    ("step_mfu", 100.0 * 4e12 / 0.004 / 989e12), ("entries_dropped_pct", 1.0)])
def test_each_metric_reads_the_synthetic_trace(name, value):
    assert run.load_reader(name)(_ctx(_trace())) == pytest.approx(value)


def test_readers_read_nothing_without_their_ranges_or_a_trace():
    assert run.load_reader("scene_rows_busy_ms")(_ctx(_trace(with_rows=False))) is None
    for name in OWN + ("device_idle_pct.train", "step_mfu"):
        assert run.load_reader(name)(_ctx(None)) is None, name
