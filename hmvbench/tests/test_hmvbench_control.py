"""The control comes out not correct, at each cell's own size on the card:
the reference computed with TF32 on (the nearest precision below the
configurations' fp32), put in the program's place and judged against the
cell's limits, on three seeds; the program on the same seeds comes out
correct. Skips without a card; on the card:

    python3 -m pytest hmvbench/tests/test_hmvbench_control.py -m cuda
"""

from __future__ import annotations

import pytest

from hmvbench import calibrate, harness

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]
SEEDS = (4000000001, 4000000002, 4000000003)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_the_program_passes(cuda, cell):
    c = harness.load_cell(cell)
    kind = harness.traffic_kind(c.traffic["kind"])
    for seed in SEEDS:
        run, state, want, program = calibrate.program_reading(c, seed, 2.0, cuda)
        control = calibrate.control_reading(kind, run, state, want)
        assert all(program[k] <= c.limits[k] for k in kind.NUMBERS), (seed, program)
        assert any(control[k] > c.limits[k] for k in kind.NUMBERS), (seed, control)
