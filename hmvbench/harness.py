"""The benchmark's driver: one run of one cell.

Everything that belongs to a cell is found by name, so that a cell, a
configuration, a traffic mix or a per-layer metric is added with files and
entries only:

  BENCHMARK.json                 the cells, the metrics, the run length
  hmvbench/configs/<config>.json the configuration as it is run
  hmvbench/traffic/<traffic>.json a traffic mix: its kind and parameters
  hmvbench/traffic/<kind>.py     the generator and window of a kind
  hmvbench/workloads/<cell>.json the cell's correctness limits
  hmvbench/metrics/<name>.py     the reader of one per-layer metric

A run checks the card, sets up the kind (the program, its weights and
inputs from the seed, the warm-up), measures the window, with ``--trace 1``
also traces two slices after it and reads the per-layer metrics, then frees
the program and judges what the window produced against the frozen
reference. The result is the last line of standard output.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# top-level modules the run may not load: the JAX package the port was made
# from, and JAX itself (compared as whole names: the port's name begins with
# the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "handmvnet_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_benchmark(repo: Path = REPO) -> dict:
    return _json(repo / "BENCHMARK.json")


def applies(metric: dict, cell: str, reported: set | None = None) -> bool:
    """Whether ``metric`` is reported in ``cell``: its ``workloads`` list
    names the cell, or, without the list, an end-to-end metric is in every
    cell and a per-layer one wherever the metric it moves is reported."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load_cell(name: str, bench: dict | None = None, root: Path = HERE) -> Cell:
    bench = load_benchmark(root.parent) if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if applies(m, name)]
    reported = {m["name"] for m in e2e}
    return Cell(
        name=name, chips=entry["chips"],
        config=_json(root.parent / config["file"]),
        traffic=_json(root / "traffic" / f"{entry['traffic']}.json"),
        limits=_json(root / "workloads" / f"{name}.json")["limits"],
        end_to_end=e2e,
        per_layer=[m for m in bench["per_layer"] if applies(m, name, reported)])


def traffic_kind(kind: str):
    return importlib.import_module(f"hmvbench.traffic.{kind}")


def metric_reader(name: str, root: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py`` (names may hold dots,
    so the file is loaded by path)."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"hmvbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclass
class Run:
    """What one run shares between the harness, its kind and the readers."""
    cell: Cell
    seed: int
    device: str
    seconds: float
    trace: bool
    values: dict = field(default_factory=dict)  # end-to-end values of the window
    window: dict = field(default_factory=dict)  # units, seconds, memory of the window
    marks: list = field(default_factory=list)  # (set-up phase, perf_counter at its end)
    summary: object = None  # the device-only traced slice's TraceSummary
    host_summary: object = None  # the slice traced with the host's calls

    def mark(self, phase: str) -> None:
        self.marks.append((phase, time.perf_counter()))

    @property
    def precision(self) -> str:
        return self.cell.config["precision"]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(run: Run, started: float) -> dict:
    """Set up, measure, trace, judge; return the result's fields (without
    ``device``'s name and count). ``started`` is when the run began, on
    ``time.perf_counter``'s clock: set-up runs from it to the window."""
    import torch
    kind = traffic_kind(run.cell.traffic["kind"])
    run.mark("start")
    state = kind.setup(run)
    setup_s = time.perf_counter() - started
    run.mark("warm-up")
    print("set-up phases (s): " + ", ".join(
        f"{name} {t - prev:.3f}" for (name, t), (_, prev) in zip(
            run.marks, [("", started)] + run.marks[:-1])), file=sys.stderr)
    kind.window(run, state)
    result: dict = {}
    if run.trace:
        kind.traced_slice(run, state)
        s = run.summary
        layer = {}
        for m in run.cell.per_layer:
            value = metric_reader(m["name"])(run)
            if value is not None:
                layer[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = layer
        result["busy_s"], result["window_s"] = s.busy_s, s.window_s
        result["breakdown"] = {"device_ops": s.device_ops(),
                               "idle_gaps": run.host_summary.idle_gaps()}
    else:
        values = dict(run.values, setup_s=setup_s)
        # a metric named <quantity>.<qualifier> reports the kind's <quantity>
        # (one quantity under bounds that differ from cell to cell)
        result["metrics"] = {m["name"]: {"value": values[m["name"].split(".")[0]],
                                         "unit": m["unit"]} for m in run.cell.end_to_end}
    result["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                   if run.device == "cuda" else 0)
    checks = kind.check(run, state)  # frees the program first
    result["checks"] = checks
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["attempted"], result["failed"] = run.window["attempted"], run.window["failed"]
    return result


def main(argv=None) -> int:
    import argparse
    started = time.perf_counter()
    parser = argparse.ArgumentParser(description="Run one benchmark cell of the port.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"hmvbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    # load from one process with few threads: the host's own work is launches
    torch.set_num_threads(1)
    run = Run(cell, args.seed, "cuda", args.seconds, bool(args.trace))
    result = execute(run, started)
    print(f"card: {card_line()}", flush=True)
    found = forbidden_modules()
    if found:
        print(f"hmvbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    checks = result.pop("checks")
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    line = {
        "correct": result["correct"], "attempted": result["attempted"],
        "failed": result["failed"], "metrics": result["metrics"],
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips, "memory_peak_bytes": result["memory_peak_bytes"]},
    }
    if run.trace:
        line["device"].update(busy_s=result["busy_s"], window_s=result["window_s"])
        line["breakdown"] = result["breakdown"]
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    return 0
