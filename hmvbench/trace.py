"""Traced slices of a run: ``torch.profiler`` over a few frames or steps
after the window, reduced to what the per-layer readers and the result's
``breakdown`` need.

A run traces two slices of the same work. The first records the device's
activity alone (CUDA), so that the host runs at its own pace: the device's
busy time is the union of the intervals of its kernels, copies and sets
(overlapping operations count once) over the slice's length on the host's
clock, each end after a synchronisation. The second records the host's
operator calls too, whose recording slows the host: it gives the kernels
launched inside the benchmark's ranges (``torch.profiler.record_function(
"hmvbench::<name>")``; a kernel belongs to a range when the host call that
launched it, matched by CUPTI's correlation id, ran inside it) and labels
the device's idle gaps with what the host was doing.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

RANGE_PREFIX = "hmvbench::"


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class TraceSummary:
    """The events of one traced slice, in host-clock nanoseconds."""

    def __init__(self, events, units: int, window_s: float):
        self.units, self.window_s = units, window_s
        self.device: list[tuple[int, int, str, int]] = []  # (start, end, name, correlation)
        self.launch_at: dict[int, int] = {}  # correlation -> host start of the launch call
        self.ranges: dict[str, list[tuple[int, int]]] = defaultdict(list)
        self.host_ops: list[tuple[int, int, str]] = []  # the host's own operator calls
        for e in events:
            start, end = e.start_ns(), e.end_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not e.is_user_annotation() and end > start:
                    self.device.append((start, end, e.name(), e.correlation_id()))
                continue
            name = e.name()
            if name.startswith(RANGE_PREFIX):
                self.ranges[name[len(RANGE_PREFIX):]].append((start, end))
            elif name.startswith(("cuda", "cu")) and e.correlation_id():
                self.launch_at[e.correlation_id()] = start
            elif name.startswith("aten::"):
                self.host_ops.append((start, end, name))
        self.busy = _union([(a, b) for a, b, _, _ in self.device])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e9

    def kernel_s(self, *names: str) -> tuple[float, int]:
        """(device seconds, launches) of the operations whose name contains
        any of ``names``."""
        hits = [b - a for a, b, n, _ in self.device if any(s in n for s in names)]
        return sum(hits) / 1e9, len(hits)

    def in_range_s(self, name: str) -> float:
        """Device seconds of the operations launched inside the range
        ``hmvbench::<name>``."""
        spans = sorted(self.ranges.get(name, ()))
        starts = [a for a, _ in spans]
        total = 0
        for a, b, _, corr in self.device:
            t = self.launch_at.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                total += b - a
        return total / 1e9

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took most time, summed by name."""
        by_name: dict[str, int] = defaultdict(int)
        for a, b, n, _ in self.device:
            by_name[n.split("(")[0][:96]] += b - a
        return [[n, t / 1e9] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """The device's idle gaps between its first and last operation,
        summed by what the host was doing at each gap's middle: the
        innermost benchmark range and the operator call."""
        edges = [x for ab in self.busy for x in ab][1:-1]
        spans = sorted(((b - a, a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a),
                       reverse=True)[:5000]  # the longest gaps carry the idle time
        self.host_ops.sort()
        op_starts = [a for a, _, _ in self.host_ops]
        gaps: dict[str, int] = defaultdict(int)
        for length, a, b in spans:
            gaps[self._host_at((a + b) // 2, op_starts)] += length
        return [[n, t / 1e9] for n, t in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]

    def _host_at(self, t: int, op_starts: list[int]) -> str:
        inner = min(((b - a, n) for n, spans in self.ranges.items()
                     for a, b in spans if a <= t <= b), default=(0, "outside ranges"))[1]
        i = bisect.bisect_right(op_starts, t)
        # the operator calls that opened last before t; the shortest holding t
        near = self.host_ops[max(0, i - 256):i]
        op = min(((b - a, n) for a, b, n in near if t <= b), default=(0, "no operator"))[1]
        return f"{inner}: {op}"


@contextmanager
def traced(summary_out: list, units: int, host: bool):
    """Profile the block, the device's activity and with ``host`` the
    host's operator calls too, and append its ``TraceSummary`` to
    ``summary_out``; ``units`` is the frames or steps the block runs."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    prof = profile(activities=activities)
    prof.start()
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prof.stop()
    summary_out.append(TraceSummary(prof.profiler.kineto_results.events(), units, t1 - t0))
