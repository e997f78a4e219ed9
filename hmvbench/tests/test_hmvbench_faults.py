"""A run with the timed path broken underneath comes out not correct: the
harness's run on the CPU (past its look for a card), at a small size, with
each fault a cell can have planted in the program (``hmvbench/faults.py``);
and the same run with nothing planted comes out correct. Serving at batch 1
has no half batch and no state to leave unchanged; one card has no
exchange between cards."""

from __future__ import annotations

import time

import pytest

from hmvbench import faults, harness
from hmvbench.tests.conftest import small_run

CASES = [(cell, None) for cell in ("r50.serve.b1v8", "r50.train.b16v5", "hr40.train.b16v5")]
CASES += [("r50.serve.b1v8", "altered")]
CASES += [(cell, fault) for cell in ("r50.train.b16v5", "hr40.train.b16v5")
          for fault in ("unchanged", "half_batch", "altered")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_correct_only_when_nothing_is_broken(cell, fault):
    run = small_run(cell, seconds=1.0)
    if fault is None:
        result = harness.execute(run, time.perf_counter())
    else:
        with faults.planted(fault):
            result = harness.execute(run, time.perf_counter())
    assert result["correct"] is (fault is None), result["checks"]
