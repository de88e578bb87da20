"""The readers of the UNet pass graphs' metrics: `unet_graph_pct` (replayed
passes over every pass the process ran on the card, from the program's pass
counters; nothing on the CPU or for a program without the counters),
`k4_fwd_busy_ms` (K4's forward kernels by name, which a replayed pass still
runs although no range opens inside it) and `peak_reserved_gib` (the
caching allocator's peak reservation, graph pools included)."""

from __future__ import annotations

import pytest
import torch

from benchmark import run
from benchmark.tests.test_benchmark_trace import EXISTING, NEW, reader_context, traced


@pytest.fixture
def counts(monkeypatch):
    from dreamscene_tpu_torch import kernels

    monkeypatch.setattr(kernels, "COUNTS", type(kernels.COUNTS)())
    return kernels.COUNTS


def test_reads_replays_over_every_pass_on_the_card(monkeypatch, counts):
    read = run.load_reader("unet_graph_pct")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert read(reader_context(traced())) is None              # no counters: the parent
    counts.update({"flash_fwd": 400, "unet_graph.capture": 2, "unet_graph.replay": 396,
                   "unet_graph.eager": 2})
    assert read(reader_context(traced())) == pytest.approx(99.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert read(reader_context(traced())) is None


def k4_trace():
    """`traced()`'s two steps with K4 forwards: per step a wgmma forward
    inside no range (a replayed pass), a split forward inside `fps.render`'s
    window (an eager one), and the backward kernels, which are not forwards."""
    tr = traced()
    for dt in (0, 2000):
        tr.busy += [(700 + dt, 760 + dt, "_anonymous_namespace_::flash_fwd_wgmma_kernel"),
                    (210 + dt, 230 + dt, "void flash_fwd_tc_split_kernel<512>"),
                    (1300 + dt, 1400 + dt, "flash_bwd_dkv_tc_kernel"),
                    (1400 + dt, 1450 + dt, "flash_bwd_dq_tc_kernel")]
    return tr


def test_k4_forwards_are_read_by_kernel_name_inside_a_range_or_not():
    read = run.load_reader("k4_fwd_busy_ms")
    assert read(reader_context(k4_trace())) == pytest.approx(0.08)   # (60 + 20) us a step
    assert read(reader_context(traced())) is None                     # no K4 forward
    assert read(reader_context(None)) is None


def test_the_new_readers_move_no_other_reading():
    tr = k4_trace()
    tr.busy = [b for b in tr.busy if "flash_bwd" not in b[2]]
    base = traced()
    base.busy = base.busy + [(s, e, "k_other") for s, e, n in tr.busy if "flash_fwd" in n]
    for name in EXISTING + NEW + ("attention_busy_ms",):
        read = run.load_reader(name)
        assert read(reader_context(tr)) == read(reader_context(base)), name


def test_reserved_peak_on_the_card_and_nothing_on_the_cpu(monkeypatch):
    read = run.load_reader("peak_reserved_gib")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "max_memory_reserved", lambda device=None: 17 * 2**30)
    assert read(reader_context(traced())) == 17.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert read(reader_context(traced())) is None
