"""Profiling helpers (counterpart of handmvnet_tpu/utils/profiling.py):

  * ``span``: the program's spans, each a named interval of the host's work
    on ``time.time_ns``, the clock of ``torch.profiler``'s events, so that a
    trace's device activity can be split by the span its launches or its idle
    gaps fall in. Off, ``span`` hands back one shared no-op context and reads
    no clock. Spans are recorded inside a ``record_spans`` block, which hands
    them to its caller, and, outside one, while a ``torch.profiler`` session
    runs, into ``profiler_spans``, where whoever reads the trace finds them;
  * ``self_ns``: each span's duration less what its child spans cover;
  * ``trace``: a ``torch.profiler`` context that writes a TensorBoard trace
    (the torch-tb-profiler plugin reads it), of the CPU and, where there is
    one, the card;
  * ``StepTimer``: per-phase wall-clock statistics (mean, p50, p99), as the
    JAX package's, summarised from the spans its ``phase`` records;
  * ``log_compile_stats``: the FLOPs of one call, counted by
    ``torch.utils.flop_counter.FlopCounterMode``. A declared divergence: the
    JAX package reads XLA's cost analysis of a compiled function, FLOPs and
    bytes accessed; eager PyTorch compiles nothing, so ``bytes_accessed`` is
    None, and the count covers the ops the counter knows (convolutions and
    matmuls, as ``profile_forward.forward_gflops`` counts them).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterator

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


@dataclass(slots=True)
class Span:
    """One recorded span. ``step``: the optimizer step it belongs to, its
    parent's where not given; ``parent``: the index, in the same record, of
    the span open on the same thread when it opened (None at the top of its
    thread); ``thread``: ``threading.get_ident()``; ``start_ns``, ``end_ns``:
    ``time.time_ns()`` (``end_ns`` 0 while open)."""

    name: str
    step: int | None
    parent: int | None
    thread: int
    start_ns: int
    end_ns: int = 0

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class SpanRecorder:
    """Spans in the order they opened. With ``limit``, spans past that many
    are not recorded, and ``dropped`` counts them."""

    def __init__(self, limit: int | None = None) -> None:
        self.spans: list[Span] = []
        self.limit, self.dropped = limit, 0
        self._stacks: dict[int, list[int]] = {}  # thread -> its open spans, innermost last
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, step: int | None = None) -> Iterator[None]:
        thread = threading.get_ident()
        stack = self._stacks.setdefault(thread, [])
        with self._lock:
            if self.limit is not None and len(self.spans) >= self.limit:
                self.dropped += 1
                index = None
            else:
                index = len(self.spans)
                parent = stack[-1] if stack else None
                if step is None and parent is not None:
                    step = self.spans[parent].step
                self.spans.append(Span(name, step, parent, thread, 0))
        if index is None:
            yield
            return
        stack.append(index)
        record = self.spans[index]
        record.start_ns = time.time_ns()
        try:
            yield
        finally:
            record.end_ns = time.time_ns()
            stack.pop()

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()
            self.dropped = 0


# the block open in ``record_spans``, if any
_recorder: SpanRecorder | None = None
# spans opened while a torch.profiler session runs outside ``record_spans``;
# bounded, since a profiler may run for a whole training
profiler_spans = SpanRecorder(limit=1 << 16)
_NO_SPAN = contextlib.nullcontext()


def span(name: str, step: int | None = None) -> contextlib.AbstractContextManager:
    """A span around the block: recorded inside ``record_spans`` and, outside
    it, while a torch.profiler session runs (into ``profiler_spans``);
    otherwise one shared no-op context."""
    recorder = _recorder
    if recorder is None:
        if not _autograd_profiler._is_profiler_enabled:
            return _NO_SPAN
        recorder = profiler_spans
    return recorder.span(name, step)


@contextlib.contextmanager
def record_spans() -> Iterator[list[Span]]:
    """Record the spans opened in the block, those of every thread; yields
    the list they land in, complete when the block ends."""
    global _recorder
    outer, _recorder = _recorder, SpanRecorder()
    try:
        yield _recorder.spans
    finally:
        _recorder = outer


def self_ns(spans: list[Span]) -> list[int]:
    """Each span's self time: its duration less the part of it that its
    child spans cover."""
    children: list[list[tuple[int, int]]] = [[] for _ in spans]
    for s in spans:
        if s.parent is not None:
            children[s.parent].append((s.start_ns, s.end_ns))
    out = []
    for s, inner in zip(spans, children):
        covered, reach = 0, s.start_ns
        for a, b in sorted(inner):
            a, b = max(a, reach), min(b, s.end_ns)
            if b > a:
                covered, reach = covered + b - a, b
        out.append(s.duration_ns - covered)
    return out


@contextlib.contextmanager
def trace(log_dir: str | Path) -> Iterator[None]:
    """Profile the block; its trace lands in ``log_dir`` on exit, for
    TensorBoard."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


class StepTimer:
    """Per-phase wall times, each phase a span of its own record;
    summary() gives each name's mean/p50/p99 over its spans' durations."""

    def __init__(self) -> None:
        self.recorder = SpanRecorder()

    def phase(self, name: str) -> contextlib.AbstractContextManager:
        return self.recorder.span(name)

    def summary(self) -> dict[str, dict[str, float]]:
        times: dict[str, list[float]] = defaultdict(list)
        for s in self.recorder.spans:
            times[s.name].append(s.duration_ns / 1e9)
        out = {}
        for name, ts in times.items():
            arr = np.asarray(ts)
            out[name] = {
                "count": int(arr.size),
                "mean_ms": float(arr.mean() * 1e3),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p99_ms": float(np.percentile(arr, 99) * 1e3),
                "total_s": float(arr.sum()),
            }
        return out

    def reset(self) -> None:
        self.recorder.clear()


def log_compile_stats(fn: Callable, *args, **kwargs) -> dict:
    """{"flops": FLOPs of ``fn(*args, **kwargs)`` (2 a multiply-add), as
    FlopCounterMode counts them, "bytes_accessed": None}; runs ``fn`` once."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": counter.get_total_flops(), "bytes_accessed": None}
