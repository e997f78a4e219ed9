"""The program's own spans in the traced slices, and their readers.

The program records a span (``handmvnet_tpu_torch.utils.profiling.span``)
while a ``torch.profiler`` session runs, into ``profiler_spans``, on
``time.time_ns``: the clock of the profiler's events. So each traced slice's
device activity splits by the spans of the same slice, without the host's
operator calls in the trace: the device's idle gaps by the spans that hold
them, and its operations by the span whose interval holds their launch call
(CUPTI's correlation id, as ``TraceSummary.in_range_s`` matches the
benchmark's ranges). A program that records no spans gives no readings.

A slice's spans are those that lie within the slice's length before its last
launch call (the runtime's calls run on the spans' clock): the
synchronisation that closes the slice, after every traced step, while the
slice's clock starts before the first. Without launch calls, its last
operation's end stands in. The other slice's spans lie seconds away.
"""

from __future__ import annotations

import bisect

from hmvbench.trace import TraceSummary, _union

SLACK_NS = 1_000_000  # the launch calls' clock against the spans', to spare


def program_spans() -> list | None:
    """The spans the program recorded while the profiler ran, or None where
    the program records none."""
    from handmvnet_tpu_torch.utils import profiling
    recorder = getattr(profiling, "profiler_spans", None)
    return None if recorder is None else recorder.spans


def slice_spans(summary: TraceSummary, spans: list) -> list:
    """The spans of ``spans`` recorded during the slice ``summary``."""
    ends = list(summary.launch_at.values()) or [b for _, b, _, _ in summary.device]
    if not ends:
        return []
    last = max(ends)
    first = last - int(summary.window_s * 1e9)
    return [s for s in spans if s.end_ns and first - SLACK_NS <= s.start_ns
            and s.end_ns <= last + SLACK_NS]


def _intervals(spans: list, names) -> list[tuple[int, int]]:
    return _union([(s.start_ns, s.end_ns) for s in spans if s.name in names])


def _overlap_ns(a: list[tuple[int, int]], b: list[tuple[int, int]]) -> int:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total = i = j = 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_lead_ns(summary: TraceSummary) -> int:
    """How far ahead of the launch calls' clock the device's operations
    read: the most by which one starts before its own launch call, which no
    operation does (0 where none reads so). On an H100 the trace's
    conversion of the device's clock has read a slice's operations 10 ms
    and more before their launch calls."""
    return max([0] + [summary.launch_at[c] - a for a, _, _, c in summary.device
                      if c in summary.launch_at])


def span_idle_s(summary: TraceSummary, spans: list, *names: str) -> float:
    """The device's idle seconds, the gaps between the intervals of its busy
    union, that fall inside the spans named ``names``; the device's
    intervals moved by its lead onto the spans' clock."""
    lead = device_lead_ns(summary)
    gaps = [(b + lead, a + lead) for (_, b), (a, _) in zip(summary.busy, summary.busy[1:])]
    return _overlap_ns(gaps, _intervals(spans, names)) / 1e9


def span_device_s(summary: TraceSummary, spans: list, *names: str) -> float:
    """Device seconds of the operations whose launch call ran inside the
    spans named ``names``: the union of their intervals, so that operations
    that overlap count once, as in the busy time."""
    inside = _intervals(spans, names)
    starts = [a for a, _ in inside]
    hits = []
    for a, b, _, corr in summary.device:
        t = summary.launch_at.get(corr)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= inside[i][1]:
            hits.append((a, b))
    return sum(b - a for a, b in _union(hits)) / 1e9


def _spans_of(summary: TraceSummary, names) -> list | None:
    spans = program_spans()
    if spans is None:
        return None
    spans = slice_spans(summary, spans)
    return spans if any(s.name in names for s in spans) else None


def span_idle_ms(*names: str):
    """A reader of the device's idle milliseconds a unit under the spans
    ``names``, in the device-only slice, where the host runs at its own
    pace."""
    def read(run):
        spans = _spans_of(run.summary, names)
        if spans is None:
            return None
        return 1e3 * span_idle_s(run.summary, spans, *names) / run.summary.units
    return read


def span_device_ms(*names: str):
    """A reader of the device milliseconds a unit of the operations launched
    under the spans ``names``: from the device-only slice where it carries
    the runtime's launch calls, else from the slice traced with the host's."""
    def read(run):
        summary = run.summary if run.summary.launch_at else run.host_summary
        spans = _spans_of(summary, names)
        if spans is None:
            return None
        seconds = span_device_s(summary, spans, *names)
        return 1e3 * seconds / summary.units if seconds else None
    return read
