"""The frozen reference against the program's CPU path at a tiny size: on the
CPU the program runs its plain versions, so a whole run of each cell (set-up,
window, trace, check) reads gaps at rounding level and comes out correct."""

from __future__ import annotations

import pytest
import torch

from benchmark import manifest, run
from benchmark.tests import tiny

torch.set_num_threads(2)


@pytest.mark.parametrize("which", ["object_sd21.fps_step", "bench_300k.render_fwd_bwd"])
def test_tiny_run_matches_the_reference(which):
    m = manifest.load()
    cell = tiny.BENCH_CELL if which == tiny.BENCH_CELL["name"] else manifest.cell(m, which)
    if which.startswith("object"):
        cfg, traffic = tiny.object_cfg(m), tiny.traffic("fps_step", warmup_steps=4)
    else:
        cfg, traffic = tiny.bench_cfg(m), tiny.traffic("render_fwd_bwd", trace_steps=2)
    res = run.run_cell(m, cell, 2**31 + 11, 0.3, True, device="cpu", cfg=cfg, traffic=traffic)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    for c in res["checks"].values():
        assert c["value"] <= 1e-6
    assert run.forbidden_modules() == []
