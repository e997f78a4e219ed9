"""Shared pieces of the benchmark's tests: cells cut to a size the CPU runs
in seconds (64^2 crops, 2 views, small batches; every width as
configured), and the ``cuda`` marker's decision (the marker is registered
in pyproject.toml), taken inside a fixture."""

from __future__ import annotations

import copy
import json

import pytest

from hmvbench import harness

SMALL_TRAFFIC = {
    "serve_closed_loop": {"views": 2, "pool": 3, "warmup_frames": 1, "check_frames": 2,
                          "reference_block": 2, "trace_frames": 2},
    "train_steps": {"batch": 4, "views": 2, "accumulate": 2, "pool": 4, "trace_steps": 1},
}


RESERVE = harness.HERE / "reserve"


def full_benchmark() -> dict:
    """BENCHMARK.json with the entries of ``reserve/<cell>.json`` added: cells
    whose kind, limits and readers stand ready but that are out of the
    benchmark until their end-to-end metric holds a bound."""
    bench = harness.load_benchmark()
    for path in sorted(RESERVE.glob("*.json")):
        for key, entries in json.loads(path.read_text()).items():
            bench[key] += entries
    return bench


def small_cell(name: str) -> harness.Cell:
    """The cell ``name`` of BENCHMARK.json, or of a reserved fragment, at a
    CPU test's size."""
    cell = copy.deepcopy(harness.load_cell(name, full_benchmark()))
    cell.config["data"].update(image_size=64, heatmap_size=8)
    cell.traffic.update(SMALL_TRAFFIC[cell.traffic["kind"]])
    return cell


def small_run(name: str, seed: int = 7, seconds: float = 0.5) -> harness.Run:
    return harness.Run(small_cell(name), seed, "cpu", seconds, trace=False)


@pytest.fixture
def cuda():
    """Skip unless a CUDA device is present (decided here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
