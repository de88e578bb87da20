"""The traffic drivers written for the cells that Open questions lists next
(no manifest entry yet): an outdoor scene's stage-1 step and the object's
refine step, each run on the CPU at a tiny size through set-up, window,
trace and check, its reference matching the program's plain path, and its
control (the reference in the precision below) reading apart."""

from __future__ import annotations

import importlib

import pytest
import torch

from benchmark import manifest
from benchmark.tests import tiny

torch.set_num_threads(2)
LIMITS = {n: {"limit": 1e-6} for n in ("loss_gap", "grad1_gap", "change_gap")}


@pytest.mark.parametrize("traffic_name", ["stage1_env_step", "recon_step"])
def test_row_driver_runs_and_matches_the_reference(traffic_name, tmp_path):
    m = manifest.load()
    if traffic_name == "stage1_env_step":
        cfg, traffic = tiny.outdoor_cfg(m), tiny.traffic(traffic_name, warmup_steps=4)
    else:
        cfg, traffic = tiny.object_cfg(m), tiny.traffic(traffic_name, views=4, num_pts=300,
                                                         warmup_steps=5)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    cell = driver.Cell(cfg, traffic, 2**31 + 13, "cpu", str(tmp_path))
    cell.setup()
    w = cell.window(0.2)
    assert w["steps"] >= 1 and w["failed"] == 0
    cell.traced(1)
    cell.release()
    checks = cell.check(LIMITS)
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    control = cell.judge(cell.reference_readings(lower=True), cell.reference_readings(), LIMITS)
    assert any(c["value"] > 1e-4 for c in control.values()), control
