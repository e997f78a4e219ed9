"""The program's spans (utils/profiling.py) on the CPU: off by default and
free of records, the training step's spans in order and nested, self time,
spans on another thread, and the spans' clock against torch.profiler's."""

import dataclasses
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from handmvnet_tpu_torch.config import Config
from handmvnet_tpu_torch.data.synthetic import synthetic_batch
from handmvnet_tpu_torch.train_step import (
    batch_to_device, build_model, create_train_state, train_step)
from handmvnet_tpu_torch.utils import profiling
from handmvnet_tpu_torch.utils.profiling import Span, SpanRecorder, record_spans, self_ns, span

CONFIG = "configs/release/HO3D_HandMvNet.yaml"
STEP = ["train_step", "forward", "backbone", "backward", "forward", "backbone", "backward",
        "clip", "adamw"]


@pytest.fixture
def profiler_spans():
    profiling.profiler_spans.clear()
    yield profiling.profiler_spans
    profiling.profiler_spans.clear()


def test_off_hands_back_one_no_op_and_records_nothing(profiler_spans):
    assert span("forward") is span("backward", 3)
    with span("forward"):
        pass
    assert profiling._recorder is None and profiler_spans.spans == []


@pytest.fixture(scope="module")
def two_steps():
    """Two steps of the HO3D release model at 64^2, 2 views, batch 2 at
    accumulation 2, their spans recorded."""
    cfg = Config.from_yaml(CONFIG)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, selected_views=(0, 1)),
                              data=dataclasses.replace(cfg.data, image_size=64, heatmap_size=8,
                                                       batch_size=2))
    state = create_train_state(build_model(cfg, "cpu", accum_steps=2), cfg, steps_per_epoch=10)
    batch = batch_to_device(synthetic_batch(2, 2, 64, 8, seed=3), "cpu")
    with record_spans() as spans:
        for _ in range(2):
            train_step(state, cfg, batch, torch.Generator().manual_seed(0), accum_steps=2)
    return spans


def test_a_training_step_records_its_spans_in_order(two_steps):
    assert [s.name for s in two_steps] == STEP * 2
    for step in (0, 1):
        spans = two_steps[9 * step:9 * step + 9]
        top = 9 * step
        assert {s.step for s in spans} == {step}
        assert {s.thread for s in spans} == {threading.get_ident()}
        assert [s.parent for s in spans] == [None, top, top + 1, top, top, top + 4, top,
                                            top, top]
        for s in spans:
            assert s.end_ns >= s.start_ns > 0
            if s.parent is not None:
                outer = two_steps[s.parent]
                assert outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns
        children = [s for s in spans if s.parent == top]
        assert all(a.end_ns <= b.start_ns for a, b in zip(children, children[1:]))


def test_self_time_is_the_duration_less_the_children(two_steps):
    top = two_steps[:9]
    own = self_ns(top)
    assert own[0] == top[0].duration_ns - sum(s.duration_ns for s in top if s.parent == 0)
    assert own[1] == top[1].duration_ns - top[2].duration_ns  # forward less its backbone
    assert own[2] == top[2].duration_ns
    spans = [Span("a", 0, None, 1, 0, 100), Span("b", 0, 0, 1, 10, 30),
             Span("c", 0, 0, 1, 25, 120), Span("d", None, None, 2, 40, 60)]
    assert self_ns(spans) == [100 - 20 - 70, 20, 95, 20]  # c clipped at a's end, d not a's


def test_a_span_on_another_thread_has_no_parent():
    def work():
        with span("backbone"):
            pass

    with record_spans() as spans:
        with span("train_step", 7):
            worker = threading.Thread(target=work)
            worker.start()
            worker.join(timeout=10)
    assert not worker.is_alive()
    (outer, inner) = spans
    assert (outer.step, outer.parent) == (7, None)
    assert (inner.name, inner.step, inner.parent) == ("backbone", None, None)
    assert inner.thread != outer.thread


def test_a_bounded_recorder_counts_what_it_drops():
    recorder = SpanRecorder(limit=2)
    for name in "abc":
        with recorder.span(name):
            pass
    assert [s.name for s in recorder.spans] == ["a", "b"] and recorder.dropped == 1


def test_spans_lie_on_the_profilers_clock(profiler_spans):
    """Under a torch.profiler session (CPU activity only) spans land in
    ``profiler_spans``, and one opened inside a ``record_function`` lies
    within that range's event, both gaps under 1 ms."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):
            torch.ones(8).add_(1)
        for _ in range(3):
            with record_function("outer"), span("inner"):
                torch.ones(8).add_(1)
    ranges = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                    if e.name() == "outer")
    assert [s.name for s in profiler_spans.spans] == ["inner"] * 3 and len(ranges) == 3
    for (a, b), s in zip(ranges, profiler_spans.spans):
        assert 0 <= s.start_ns - a < 1_000_000 and 0 <= b - s.end_ns < 1_000_000
    with span("after"):
        pass
    assert len(profiler_spans.spans) == 3
