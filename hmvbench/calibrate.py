"""The readings a cell's correctness limits are set from, on the card:

    python3 hmvbench/calibrate.py --workload <name> --seeds 1,2,3 [--control-seeds 1,2,3]
        [--seconds 2] [--faults half_batch]

For each seed, in one process: the program's numbers (a short window at the
cell's own load, then the comparison a run makes); for each control seed,
the control's numbers (the reference computed with TF32 on, the nearest
precision below the configuration's fp32, judged as the program is); for
each fault and control seed, the numbers of the program with that fault
planted (``faults.py``). One JSON line a reading, a summary line last. A
benchmark run never runs this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build" / "torch_extensions")
sys.path.insert(0, str(CHECKOUT))

from hmvbench import faults, harness  # noqa: E402


def program_reading(cell, seed: int, seconds: float, device: str, fault: str | None = None):
    """(run, state, numbers) of one short run of the program."""
    run = harness.Run(cell, seed, device, seconds, trace=False)
    kind = harness.traffic_kind(cell.traffic["kind"])
    if fault is None:
        state = kind.setup(run)
        kind.window(run, state)
    else:
        with faults.planted(fault):
            state = kind.setup(run)
            kind.window(run, state)
    kind.release(state)
    want = (kind.reference_outputs(run, state) if hasattr(kind, "reference_outputs")
            else kind.reference_record(run, state))
    got = state.sample if hasattr(kind, "reference_outputs") else state.record
    numbers = kind.compare(got, want)
    if hasattr(kind, "diagnostics"):
        numbers["not_judged"] = kind.diagnostics(got, want)
    return run, state, want, numbers


def control_reading(kind, run, state, want) -> dict:
    """The control's numbers: the reference at TF32, judged against the
    reference at fp32 as the program is."""
    if hasattr(kind, "reference_outputs"):
        low = kind.reference_outputs(run, state, tf32=True)
        return kind.compare([(k, o) for (k, _), o in zip(state.sample, low)], want)
    low = kind.reference_record(run, state, tf32=True)
    return dict(kind.compare(low, want), not_judged=kind.diagnostics(low, want))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--faults", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    cell = harness.load_cell(args.workload)
    kind = harness.traffic_kind(cell.traffic["kind"])
    print(f"card: {harness.card_line()}", flush=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    planted = [f for f in args.faults.split(",") if f]
    table: dict = {"program": [], "control": []}
    for seed in sorted(set(seeds) | set(control)):
        t = time.perf_counter()
        run, state, want, numbers = program_reading(cell, seed, args.seconds, "cuda")
        line = {"seed": seed, "units": run.window["units"]}
        if seed in seeds:
            line["program"] = numbers
            table["program"].append(numbers)
        if hasattr(state, "sample"):
            line["softargmax_peak"] = kind.peak_share(state)
        if seed in control:
            line["control"] = control_reading(kind, run, state, want)
            table["control"].append(line["control"])
            for fault in planted:
                numbers = program_reading(cell, seed, args.seconds, "cuda", fault)[3]
                line[fault] = numbers
                table.setdefault(fault, []).append(numbers)
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
    summary = {side: {k: [min(r[k] for r in rows), max(r[k] for r in rows)]
                      for k in kind.NUMBERS} for side, rows in table.items() if rows}
    print(json.dumps({"workload": args.workload, "min_max": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
