"""A run with the timed path broken underneath comes out not correct, once for
each fault a cell can have: a training step that returns its state
unchanged, half of the batch left out (the mean taken over the rest), and an
answer altered where it is produced. The harness's look for a card is
skipped: the runs are the cells' code paths at a tiny size on the CPU,
judged by the cells' own limits."""

from __future__ import annotations

import pytest
import torch

from benchmark import manifest, run
from benchmark.drivers.object_fps import half_batch
from benchmark.tests import tiny

torch.set_num_threads(2)


def _fps_run(m):
    cell = manifest.cell(m, "object_sd21.fps_step")
    return run.run_cell(m, cell, 2**31 + 17, 0.2, False, device="cpu",
                        cfg=tiny.object_cfg(m), traffic=tiny.traffic("fps_step",
                                                                      warmup_steps=4))


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_training_fault_is_not_correct(fault, monkeypatch):
    from dreamscene_tpu_torch.training import object_trainer as OT

    orig = OT.fps_step

    def broken(**kw):
        if fault == "half_batch":
            return orig(**half_batch(kw))
        res = orig(**kw)
        st = kw["state"]
        return dict(res, params=st.params, opt=st.opt)

    monkeypatch.setattr(OT, "fps_step", broken)
    res = _fps_run(manifest.load())
    assert not res["correct"], res["checks"]


def test_altered_answer_is_not_correct(monkeypatch):
    from dreamscene_tpu_torch.ops import rasterizer

    orig = rasterizer.render

    def altered(*a, **kw):
        out = orig(*a, **kw)
        img = out["image"].clone()
        img[:, :8, :8] += 0.05
        return dict(out, image=img)

    monkeypatch.setattr(rasterizer, "render", altered)
    m = manifest.load()
    cell = tiny.BENCH_CELL
    res = run.run_cell(m, cell, 2**31 + 19, 0.2, False, device="cpu", cfg=tiny.bench_cfg(m))
    assert not res["correct"], res["checks"]


def test_sound_tiny_run_is_correct():
    res = _fps_run(manifest.load())
    assert res["correct"], res["checks"]

