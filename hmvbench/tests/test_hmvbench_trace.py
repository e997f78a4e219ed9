"""The trace's arithmetic on made-up events: the union of the device's
intervals, kernels by name, kernels in a range by their launch, idle gaps."""

from __future__ import annotations

import pytest
import torch

from hmvbench.trace import TraceSummary


class Event:
    def __init__(self, name, start, end, cuda=False, corr=0):
        self._n, self._a, self._b, self._cuda, self._c = name, start, end, cuda, corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._cuda else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return False

    def correlation_id(self):
        return self._c


EVENTS = [
    Event("hmvbench::backbone", 0, 100),
    Event("aten::conv", 5, 40),
    Event("cudaLaunchKernel", 10, 12, corr=1),
    Event("cudaLaunchKernel", 50, 52, corr=2),
    Event("cudaLaunchKernel", 150, 152, corr=3),
    Event("stem_conv_tf32x3_wgmma(float)", 20, 60, cuda=True, corr=1),
    Event("gemm", 40, 80, cuda=True, corr=2),  # overlaps the first
    Event("attention_fwd_tf32x3_mma", 160, 170, cuda=True, corr=3),
]


def test_busy_is_the_union():
    s = TraceSummary(EVENTS, units=2, window_s=200e-9)
    assert s.busy == [(20, 80), (160, 170)]
    assert s.busy_s == 70e-9 and s.window_s == 200e-9


def test_kernels_by_name_and_by_range():
    s = TraceSummary(EVENTS, units=2, window_s=200e-9)
    assert s.kernel_s("stem_conv_") == (40e-9, 1)
    assert s.kernel_s("attention_fwd_", "attention_tiles_") == (10e-9, 1)
    assert s.in_range_s("backbone") == 80e-9  # launched at 10 and 50, inside [0, 100]


def test_idle_gaps_are_labelled_by_the_host():
    s = TraceSummary(EVENTS, units=2, window_s=200e-9)
    assert s.idle_gaps() == [["outside ranges: no operator", 80e-9]]
    assert s.device_ops()[0] == ["stem_conv_tf32x3_wgmma", 40e-9]


def test_readers_on_a_made_up_slice():
    """The shared readers: the idle share is the slice's own uncovered
    share; K2's bound counts each of a training step's microbatches."""
    from hmvbench import counts, readers
    from hmvbench.tests.conftest import small_run
    run = small_run("r50.train.b16v5")
    run.summary = TraceSummary(EVENTS, units=2, window_s=200e-9)
    assert readers.idle_share(run) == pytest.approx(65.0)
    p, size = run.cell.traffic, run.cell.config["data"]["image_size"]
    one = counts.bound_s(*counts.k2_work(p["batch"] // p["accumulate"] * p["views"], size,
                                         "float32"), "float32")
    assert readers.k2_roofline(run) == pytest.approx(100.0 * one * p["accumulate"] * 2 / 40e-9)
    assert readers.range_device_ms("nothing")(
        type("R", (), {"host_summary": run.summary})()) is None
