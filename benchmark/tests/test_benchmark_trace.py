"""Reading the program's ranges out of a trace (`spans.py`): the rule that
charges each idle gap of the device to a range, the count of the host's
blocking synchronizations and their place by host span, and that the
program's new ranges change none of the readings the trace gave without
them. On synthetic traces, so on the CPU; the last test runs one tiny step
on the card (marked `cuda`: `python -m pytest benchmark/tests -m cuda`)."""

from __future__ import annotations

import types
import warnings

import pytest

from benchmark import run, spans
from benchmark import trace as T
from benchmark.tests import tiny

MAIN, AUTOGRAD = 1, 2


def shifted(events, dt):
    return [(a + dt, b + dt, *rest) for a, b, *rest in events]


# one step on the device (us): the input draw, three kernels of the render,
# a gap, the backward's two kernels, a gap, Adam's; two such steps 2000 us
# apart, then the harness's own kernel
STEP = [(100, 150, "k_draw"), (200, 300, "k_render_a"), (250, 360, "k_render_b"),
        (400, 500, "k_render_c"), (1000, 1100, "k_bwd_a"), (1104, 1200, "k_bwd_b"),
        (1600, 1700, "k_adam")]
BUSY = STEP + shifted(STEP, 2000) + [(4500, 4600, "k_harness")]
# the device windows of the ranges the parent program has, and of those the
# program's spans add
PARENT_RANGES = {"fps.render": [(200, 500), (2200, 2500)],
                 "fps.adam": [(1600, 1700), (3600, 3700)]}
SPAN_RANGES = {"fps.step": [(100, 1700), (2100, 3700)],
               "fps.step_inputs": [(100, 150), (2100, 2150)],
               "fps.render.bwd": [(1000, 1200), (3000, 3200)]}
STEP_SPANS = [(0, 1800, "fps.step", MAIN), (0, 95, "fps.step_inputs", MAIN),
              (95, 510, "fps.render", MAIN), (510, 1550, "fps.backward", MAIN),
              (950, 1210, "fps.render.bwd", AUTOGRAD), (1550, 1720, "fps.adam", MAIN),
              (1720, 1800, "fps.sync", MAIN)]
SPANS = STEP_SPANS + shifted(STEP_SPANS, 2000)
# the steps' blocking synchronizations, then the harness's and the
# profiler's after them
SYNCS = [(1750, 1760, "cudaStreamSynchronize", MAIN),
         (3750, 3760, "cudaStreamSynchronize", MAIN),
         (1000, 1001, "cudaStreamSynchronize", AUTOGRAD),
         (520, 521, "cudaStreamSynchronize", MAIN),
         (30, 31, "cudaStreamSynchronize", MAIN),
         (3800, 4490, "cudaDeviceSynchronize", MAIN),
         (4700, 4710, "cudaDeviceSynchronize", MAIN)]
HOST = [(0, 90, "aten::randn"), (95, 120, "cudaLaunchKernel"), (500, 990, "aten::mul"),
        (1200, 1590, "aten::add_"), (1700, 2090, "aten::copy_")] + [s[:3] for s in SYNCS]


def parent_trace() -> T.Trace:
    """What the parent program gives: no windows of the new ranges (the
    trace records the synchronizations all the same)."""
    return T.Trace(busy=list(BUSY), ranges=dict(PARENT_RANGES), host=list(HOST),
                   wall_s=0.005, n_steps=2)


def traced() -> T.Trace:
    tr = parent_trace()
    tr.ranges = {**PARENT_RANGES, **SPAN_RANGES}
    return tr


def test_idle_gap_goes_to_the_innermost_window_of_the_work_that_ends_it():
    # per step: 150 -> 200 and 360 -> 400 end in the render's kernels (in
    # fps.render within fps.step), 500 -> 1000 in the backward's (in
    # fps.render.bwd), 1100 -> 1104 is under 5 us, 1200 -> 1600 ends in
    # Adam's; 1700 -> 2100 ends in the next step's draw (fps.step_inputs,
    # shorter than that step's fps.step); 3700 -> 4500 in a kernel that no
    # window holds
    assert dict(spans.idle_by_span(traced())) == pytest.approx({
        "fps.render": 180e-6, "fps.render.bwd": 1000e-6, "fps.adam": 800e-6,
        "fps.step_inputs": 400e-6, spans.NO_SPAN: 800e-6})
    fine = dict(spans.idle_by_span(traced(), min_gap_us=1.0))
    assert fine["fps.render.bwd"] == pytest.approx(1008e-6)
    assert sum(fine.values()) == pytest.approx(3188e-6)
    # a window that starts at the event holds it; one that ends there does not
    assert spans.innermost([(0, 10, "a"), (10, 20, "b"), (0, 30, "c")], 10) == "b"
    assert spans.innermost([(0, 10, "a")], 10) == spans.NO_SPAN


def test_syncs_go_to_the_innermost_span_on_their_thread():
    # the two reads in fps.sync; the autograd thread's inside fps.render.bwd
    # (not fps.backward, open on the main thread at that moment); one in
    # fps.backward on the main thread; the harness's and the profiler's
    # after the steps; one in fps.step_inputs
    assert dict(spans.syncs_by_span(SPANS, SYNCS)) == {
        "fps.sync": 2, "fps.render.bwd": 1, "fps.backward": 1, spans.NO_SPAN: 2,
        "fps.step_inputs": 1}
    assert spans.syncs_by_span([], SYNCS) == [(spans.NO_SPAN, 7)]


@pytest.mark.parametrize("closing, expect", [
    (("cudaDeviceSynchronize", "cudaDeviceSynchronize"), 5),  # the harness's, the profiler's
    (("cudaDeviceSynchronize",), 5),
    (("cudaDeviceSynchronize", "cudaStreamSynchronize"), 7),  # a sync after them: all count
    ((), 5),
])
def test_step_syncs_leave_out_the_closing_device_synchronizations(closing, expect):
    tr = traced()
    steps = [h for h in HOST if h[2] != "cudaDeviceSynchronize"]
    tr.host = steps + [(4000 + 100 * i, 4050 + 100 * i, n) for i, n in enumerate(closing)]
    assert spans.step_syncs(tr, "fps.step") == expect
    assert spans.step_syncs(tr, "scene.step") is None
    assert spans.step_syncs(parent_trace(), "fps.step") is None


def reader_context(tr):
    win = dict(steps=4, seconds=2.0, attempted=4, failed=0, rungs=[3, 2, 3, 4],
               n_entries=1000, n_dropped=10)
    return run.Context(setup_s=1.0, window=win, trace=tr, cfg={}, traffic={},
                       peak_window_bytes=0,
                       run=types.SimpleNamespace(step_flops=lambda r: 1e12 * sum(r)))


EXISTING = ("device_idle_pct.train", "guidance_busy_ms", "render_busy_ms",
            "entries_dropped_pct", "step_mfu")
NEW = ("render_bwd_busy_ms", "guidance_bwd_busy_ms", "inputs_idle_ms", "host_syncs_per_step")


def test_new_ranges_change_no_existing_reading():
    old, new = parent_trace(), traced()
    assert old.busy_s == new.busy_s
    for names in (("fps.render",), ("fps.adam",), ("fps.vae_encode", "fps.ladder")):
        assert old.in_ranges(names) == new.in_ranges(names)
    assert old.idle_by_host_op() == new.idle_by_host_op()
    b_old, b_new = old.breakdown(), new.breakdown()
    assert b_old == b_new
    for name in EXISTING:
        read = run.load_reader(name)
        assert read(reader_context(old)) == read(reader_context(new)), name


def test_new_readers_read_the_ranges_and_are_silent_without_them():
    values = {n: run.load_reader(n)(reader_context(traced())) for n in NEW}
    assert values == {"render_bwd_busy_ms": pytest.approx(0.196),
                      "guidance_bwd_busy_ms": None,
                      "inputs_idle_ms": pytest.approx(0.2),
                      "host_syncs_per_step": 2.5}
    for name in NEW:
        assert run.load_reader(name)(reader_context(parent_trace())) is None, name
        assert run.load_reader(name)(reader_context(None)) is None, name


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the rasterizer's kernels have no CPU mode")


@pytest.mark.cuda
def test_backward_windows_and_sync_count_on_the_card(card, tmp_path):
    """One tiny object step under the harness's profiler on the card: both
    backward ranges get a device window that holds work, and the runtime's
    count of blocking synchronizations in the step (`spans.step_syncs`)
    equals the warnings that torch's sync debug mode raises over the same
    step. A second step, traced with the host spans, puts every one of its
    synchronizations inside `fps.step`."""
    import importlib

    import torch

    cfg, traffic = tiny.object_cfg(), tiny.traffic("fps_step", warmup_steps=4)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    cell = driver.Cell(cfg, traffic, 2**31 + 17, "cuda", str(tmp_path))
    cell.setup()
    caught = []

    def step():
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                cell.traced(1)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # the mode's own notice when it is switched on is no synchronization
        caught.extend(w for w in got if "called a synchronizing" in str(w.message))

    tr = T.capture(step, 1, torch.cuda.synchronize)
    for name in ("fps.render.bwd", "fps.vae_encode.bwd"):
        assert tr.ranges.get(name), (name, sorted(tr.ranges))
        assert tr.in_ranges((name,)) > 0, name
    assert spans.step_syncs(tr, "fps.step") == len(caught), (
        [h[2] for h in tr.host if h[2] in spans.SYNC_CALLS],
        [str(w.message)[:80] for w in caught])
    tr2, host_spans, syncs = spans.capture_spans(lambda: cell.traced(1), 1,
                                                 torch.cuda.synchronize)
    step_spans = [s for s in host_spans if s[2] == "fps.step"]
    assert len(step_spans) == 1
    a, b = step_spans[0][:2]
    inside = [s for s in syncs if a <= s[0] < b]
    after = [s[2] for s in syncs if s[0] >= b]
    assert len(inside) == spans.step_syncs(tr2, "fps.step") > 0, (
        spans.syncs_by_span(host_spans, syncs))
    assert len(inside) + len(after) == len(syncs)
    assert set(after) == {"cudaDeviceSynchronize"}, after
