"""The reader of `norm_kernel_pct`: the norm elements the hand-written
kernels took over every norm element on the card, forward and backward, from
the program's counters; nothing on the CPU or for a program without the
counters."""

from __future__ import annotations

import pytest
import torch

from benchmark import run
from benchmark.tests.test_benchmark_trace import reader_context, traced
from benchmark.tests.test_benchmark_unet_graph import counts  # noqa: F401 (fixture)


def test_reads_kernel_norms_over_every_norm_on_the_card(monkeypatch, counts):  # noqa: F811
    read = run.load_reader("norm_kernel_pct")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert read(reader_context(traced())) is None              # no counters: the parent
    counts.update({"flash_fwd": 400, "unet_graph.replay": 36, "group_norm_fwd": 8})
    assert read(reader_context(traced())) is None              # counters, but no elements
    counts.update({"norm.kernel_elems": 3_826_000_000, "norm.torch_elems": 970_000_000})
    assert read(reader_context(traced())) == pytest.approx(100.0 * 3826 / 4796)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert read(reader_context(traced())) is None
