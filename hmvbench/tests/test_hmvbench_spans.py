"""The readers of the program's spans on a made-up slice: idle split across
spans, a gap across a span's edge, a launch outside every span, the slice's
own spans, a program without spans; and the span metrics' entries."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from hmvbench import harness, spans
from hmvbench.trace import TraceSummary
from hmvbench.tests.test_hmvbench_trace import Event
from handmvnet_tpu_torch.utils import profiling
from handmvnet_tpu_torch.utils.profiling import Span, SpanRecorder

REPO = Path(__file__).resolve().parents[2]
SPAN_METRICS = ["idle_forward_ms", "idle_backward_ms", "idle_optimizer_ms", "backward_device_ms",
                "backbone_device_ms"]

# four operations, each started after its launch call; the gaps (200, 300),
# (400, 500), (600, 900); the last operation launched after every span
EVENTS = [Event("cudaLaunchKernel", t, t + 2, corr=i)
          for i, t in enumerate((50, 290, 460, 870), start=1)]
EVENTS += [Event(f"k{i}", a, a + 100, cuda=True, corr=i)
           for i, a in enumerate((100, 300, 500, 900), start=1)]
SPANS = [Span("train_step", 0, None, 1, 0, 850), Span("forward", 0, 0, 1, 0, 280),
         Span("backbone", 0, 1, 1, 10, 100), Span("backward", 0, 0, 1, 280, 450),
         Span("clip", 0, 0, 1, 450, 650), Span("adamw", 0, 0, 1, 650, 850)]


def summary(events=EVENTS) -> TraceSummary:
    return TraceSummary(events, units=2, window_s=1000e-9)


def test_idle_splits_across_spans_and_at_their_edges():
    s = summary()
    assert s.busy == [(100, 200), (300, 400), (500, 600), (900, 1000)]
    idle = {n: spans.span_idle_s(s, SPANS, n) for n in ("forward", "backward", "clip", "adamw")}
    # each gap across a span's edge; (850, 900) after every span
    assert idle == {"forward": 80e-9, "backward": 70e-9, "clip": 100e-9, "adamw": 200e-9}
    assert spans.span_idle_s(s, SPANS, "clip", "adamw") == 300e-9
    assert spans.span_idle_s(s, SPANS, "train_step") == 450e-9 == sum(idle.values())
    assert spans.span_idle_s(s, SPANS, "backbone") == 0.0


def test_idle_moves_with_a_device_clock_that_reads_early():
    """Operations that read 200 early, 190 before their own launch calls at
    most, are moved by those 190 onto the spans' clock."""
    def shifted(by):
        return summary(EVENTS[:4] + [Event(e.name(), e.start_ns() + by, e.end_ns() + by, True,
                                           e.correlation_id()) for e in EVENTS[4:]])
    early = shifted(-200)
    assert spans.device_lead_ns(early) == 190 and spans.device_lead_ns(summary()) == 0
    for names in (("forward",), ("backward",), ("clip", "adamw")):
        assert spans.span_idle_s(early, SPANS, *names) == spans.span_idle_s(
            shifted(-10), SPANS, *names)


def test_device_time_follows_the_launch():
    s = summary()
    got = {n: spans.span_device_s(s, SPANS, n) for n in ("forward", "backbone", "backward",
                                                         "clip", "adamw")}
    assert got == {"forward": 100e-9, "backbone": 100e-9, "backward": 100e-9, "clip": 100e-9,
                   "adamw": 0.0}
    # the fourth operation, launched at 870, lies in no span
    assert spans.span_device_s(s, SPANS, "train_step") == 300e-9 < s.busy_s


def test_a_slice_keeps_its_own_spans():
    later = Span("forward", 9, None, 1, 5_000_000_000, 5_000_000_300)
    assert spans.slice_spans(summary(), SPANS + [later]) == SPANS
    assert spans.slice_spans(summary(EVENTS[4:]), SPANS + [later]) == SPANS  # no launch calls
    assert spans.slice_spans(summary([]), SPANS) == []
    # the device's operations may read earlier than the launch calls' clock:
    # the closing synchronisation bounds the slice
    step = Span("train_step", 0, None, 1, 0, 3_000_000)
    closing = Event("cudaDeviceSynchronize", 3_100_000, 3_200_000, corr=5)
    closed = TraceSummary(EVENTS + [closing], units=2, window_s=4e-3)
    assert spans.slice_spans(closed, [step, later]) == [step]
    assert spans.slice_spans(TraceSummary(EVENTS, units=2, window_s=4e-3), [step]) == []


@pytest.fixture
def run(monkeypatch):
    from hmvbench.tests.conftest import small_run
    recorder = SpanRecorder()
    recorder.spans += SPANS
    monkeypatch.setattr(profiling, "profiler_spans", recorder)
    r = small_run("r50.train.b16v5")
    r.summary = summary()
    r.host_summary = summary()
    return r


def test_the_readers_per_step(run):
    read = {n: harness.metric_reader(f"{n}.train")(run) for n in SPAN_METRICS}
    assert read == pytest.approx({"idle_forward_ms": 4e-5, "idle_backward_ms": 3.5e-5,
                                  "idle_optimizer_ms": 1.5e-4, "backward_device_ms": 5e-5,
                                  "backbone_device_ms": 5e-5})
    assert harness.metric_reader("backbone_device_ms.train.hr40")(run) == read[
        "backbone_device_ms"]


def test_device_time_from_the_host_slice_without_launches(run):
    run.summary = summary(EVENTS[4:])
    run.host_summary = TraceSummary(EVENTS[:4] + [Event(e.name(), e.start_ns() + 10,
                                                        e.end_ns() + 10, True, e.correlation_id())
                                                  for e in EVENTS[4:]], 2, 1000e-9)
    assert spans.span_device_ms("backward")(run) == pytest.approx(5e-5)
    assert spans.span_idle_ms("forward")(run) == pytest.approx(4e-5)


def test_a_program_without_spans_reads_nothing(run, monkeypatch):
    monkeypatch.delattr(profiling, "profiler_spans")
    assert spans.program_spans() is None
    for n in SPAN_METRICS:
        assert harness.metric_reader(f"{n}.train.hr40")(run) is None
    monkeypatch.setattr(profiling, "profiler_spans", SpanRecorder(), raising=False)
    assert harness.metric_reader("idle_forward_ms.train")(run) is None


@pytest.mark.parametrize("qualifier", ["", ".hr40"])
@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_each_span_metric_has_its_file_and_one_accepted_cell(metric, qualifier):
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    name = f"{metric}.train{qualifier}"
    (entry,) = [m for m in bench["per_layer"] if m["name"] == name]
    assert (REPO / "hmvbench" / "metrics" / f"{name}.py").is_file()
    cell = "hr40.train.b16v5" if qualifier else "r50.train.b16v5"
    assert entry["workloads"] == [cell] and cell in {w["name"] for w in bench["workloads"]}
    assert entry["source"] == "program_span" and entry["moves"] == (
        "train_samples_per_s" + qualifier)
