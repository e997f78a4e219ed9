"""Profiling helpers (counterpart of handmvnet_tpu/utils/profiling.py):

  * ``trace``: a ``torch.profiler`` context that writes a TensorBoard trace
    (the torch-tb-profiler plugin reads it), of the CPU and, where there is
    one, the card;
  * ``StepTimer``: per-phase wall-clock statistics (mean, p50, p99), a copy;
  * ``log_compile_stats``: the FLOPs of one call, counted by
    ``torch.utils.flop_counter.FlopCounterMode``. A declared divergence: the
    JAX package reads XLA's cost analysis of a compiled function, FLOPs and
    bytes accessed; eager PyTorch compiles nothing, so ``bytes_accessed`` is
    None, and the count covers the ops the counter knows (convolutions and
    matmuls, as ``profile_forward.forward_gflops`` counts them).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Iterator

import numpy as np
import torch


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
    """Accumulates per-phase wall times; summary() gives mean/p50/p99."""

    def __init__(self) -> None:
        self._times: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._times[name].append(time.perf_counter() - t0)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, ts in self._times.items():
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
        self._times.clear()


def log_compile_stats(fn: Callable, *args, **kwargs) -> dict:
    """{"flops": FLOPs of ``fn(*args, **kwargs)`` (2 a multiply-add), as
    FlopCounterMode counts them, "bytes_accessed": None}; runs ``fn`` once."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": counter.get_total_flops(), "bytes_accessed": None}
