"""The `attention_busy_ms` reader on a synthetic trace (`test_benchmark_trace`'s
steps): device time starting inside the program's `sd.attention` windows,
nothing for a program without the range, and no other reading moved by the
range's windows."""

from __future__ import annotations

import pytest

from benchmark import run
from benchmark.tests.test_benchmark_trace import EXISTING, NEW, reader_context, traced


def test_attention_reader_reads_its_range_and_moves_no_other_reading():
    # per step: k_render_a (100 us) and k_render_b (110 us) start inside the
    # attention windows, counted once where two windows overlap; a window
    # that no kernel starts in adds nothing
    tr = traced()
    tr.ranges = {**tr.ranges, "sd.attention": [(190, 255), (200, 260), (1500, 1550),
                                               (2200, 2260)]}
    read = run.load_reader("attention_busy_ms")
    assert read(reader_context(tr)) == pytest.approx(0.21)
    assert read(reader_context(traced())) is None
    assert read(reader_context(None)) is None
    for name in EXISTING + NEW:
        other = run.load_reader(name)
        assert other(reader_context(tr)) == other(reader_context(traced())), name
