"""The control of each cell (and of the render cell kept out of
BENCHMARK.json), on the card at the cell's own size: the
reference put in the program's place in the precision below the
configuration's (the rasterizer's records in bfloat16, the guidance's kernels
in fp8) must come out not correct, and the program correct, on three seeds.
Card only (marked `cuda`): `python -m pytest benchmark/tests -m cuda`."""

from __future__ import annotations

import json

import pytest

from benchmark import manifest, readings, run
from benchmark.tests import tiny

SEEDS = (4000000007, 4000000009, 4000000013)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells' kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("which", ["object_sd21.fps_step", "bench_300k.render_fwd_bwd"])
def test_control_is_not_correct(card, which, seed):
    m = manifest.load()
    cell = tiny.BENCH_CELL if which == tiny.BENCH_CELL["name"] else manifest.cell(m, which)
    cfg = tiny.config(cell["config"])
    run.set_environment(cfg)
    limits = json.loads(manifest.limits_file(which).read_text())
    r = readings.readings(m, cell, seed, 1.0, True, cfg=cfg)
    names = [k for k in limits if k != "about"]
    assert all(r["program"][k] <= limits[k]["limit"] for k in names), r
    assert "error" in r["control"] or any(
        r["control"][k] > limits[k]["limit"] for k in names), r
