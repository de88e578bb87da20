"""The port's outdoor stage-1 scene step (config #5's `only_env` env step)
against the benchmark's plain reference (`benchmark/reference/scene.py`,
`scene_init.py`), on the CPU at a tiny size: the outdoor box with an env
shell and floor disk at density 0.0005, 32x32 renders, C_batch 2, a tiny
UNet and VAE with seeded weights (`benchmark/tests/tiny.py`).

Three recorded steps from the program's initial env and floor, the
reference stepping the same recorded inputs from the same state:
  * every step's loss, rtol 1e-5 (the two are the same float32 sums in
    other orders);
  * the first step's gradient as Adam took it, each leaf's relative L2
    difference <= 1e-4;
  * the parameters' change over the steps, each leaf's relative L2
    difference <= 1e-4 (on the CPU both take the same float32 steps, and
    Adam's normalized update leaves no row of round-off gradient apart);
  * the env's and floor's initial positions equal the seed's draw, and
    their log-scales the exact 3-nearest-neighbour ones to 1e-5.
The step's profiler ranges: `scene.rows` inside `scene.render`, and
`scene.densify` around a densification. `last_stats["n_rows"]` is the
rows the step concatenated: the visible models' capacities.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.drivers import scene_stage1_settled as D
from benchmark.tests import tiny
from tests.test_torch_tracing import by_name, inside, scene_trainer

torch.set_num_threads(1)


def rel_l2(a, b) -> float:
    return float(torch.linalg.vector_norm((a - b).double())
                 / max(float(torch.linalg.vector_norm(b.double())), 1e-30))


@pytest.fixture(scope="module", params=[2**31 + 101, 3_000_000_019])
def stepped(request, tmp_path_factory):
    """The cell of `drivers/scene_stage1_settled` after set-up (three recorded steps), and the
    reference's readings over the same steps."""
    traffic = tiny.traffic("stage1_env_settled", warmup_steps=3, init_sample=64)
    cell = D.Cell(tiny.outdoor_cfg(), traffic, request.param, "cpu",
                  str(tmp_path_factory.mktemp("outdoor")))
    cell.setup()
    return cell, cell.reference_readings()


def test_losses_match_the_reference(stepped):
    cell, ref = stepped
    assert len(cell.program["losses"]) == 3
    np.testing.assert_allclose(cell.program["losses"], ref["losses"], rtol=1e-5)


def test_first_gradient_and_change_match_the_reference(stepped):
    cell, ref = stepped
    prog = cell.program
    assert sorted(prog["grad1"]) == sorted(ref["grad1"])
    assert {k.split(".")[0] for k in prog["grad1"]} == {"env"}
    for k, g in ref["grad1"].items():
        assert rel_l2(prog["grad1"][k], g) <= 1e-4, k
        assert rel_l2(prog["change"][k], ref["change"][k]) <= 1e-4, k
    assert any(v.any() for v in ref["change"].values())


def test_initial_env_and_floor_match_the_seed(stepped):
    cell, ref = stepped
    for name in ("floor", "env"):
        p, r = cell.program["init"][name], ref["init"][name]
        assert p["xyz"].shape == r["xyz"].shape and p["xyz"].shape[0] > 100
        assert torch.equal(p["xyz"], r["xyz"]), name
        torch.testing.assert_close(p["log_scale"], r["log_scale"], rtol=0, atol=1e-5)
    checks = cell.judge(cell.program, ref, {k: {"limit": 1.0} for k in (
        "loss_gap", "grad1_gap", "change_gap", "init_xyz_gap", "init_scale_gap")})
    assert checks["init_xyz_gap"]["value"] == 0.0


def test_rows_and_densify_ranges_open_in_a_profiled_step(tmp_path):
    tr = scene_trainer(tmp_path)
    optp = tr.cfg.sceneOptimizationParams
    optp.densify_from_iter, optp.densification_interval = 1, 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.scene_train_step(tr._stage1_cams(2), "env", only_env=False)
    spans = by_name(prof, "scene.")
    assert len(spans["scene.rows"]) == 1 and len(spans["scene.densify"]) == 1
    assert inside(spans["scene.rows"][0], spans["scene.render"][0])
    assert inside(spans["scene.render"][0], spans["scene.step"][0])
    assert spans["scene.step"][0].time_range.end <= spans["scene.densify"][0].time_range.start


@pytest.mark.parametrize("only_env", [True, False])
def test_n_rows_counts_the_rows_concatenated(only_env, tmp_path):
    tr = scene_trainer(tmp_path)
    tr.scene_train_step(tr._stage1_cams(2), "env", only_env=only_env)
    states = tr._states(tr._visible_names(only_env))
    assert len(states) == (2 if only_env else 3)
    assert tr.last_stats["n_rows"] == sum(s.capacity for s in states)
