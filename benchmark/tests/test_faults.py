"""The output check against faults in the timed path, on the CPU.

Each cell runs at a small size (`_cells.tiny`), where its sound run sits at
float rounding of the reference as at the cells' own size, and is held to
the cell's own limits.  With each fault the cell
can have planted underneath (`faults.py`), the run's `correct` comes out
false.  The same faults at the cells' own sizes are read on the card
(`calibrate.py`; PERF.md gives the readings)."""

import pytest

from benchmark import faults, harness
from benchmark.tests import _cells

SEED = 2**31 + 4242
# The faults each cell can have (PERF.md gives their readings on the card).
CASES = ([("dsec_zurich04.replay_dense", f) for f in ("stale", "half", "altered")]
         + [("mvsec_flying1_athc.replay", f) for f in ("stale", "half", "state", "altered")])


def _run(cell: str):
    return harness.run(_cells.tiny(cell), SEED, 0.5, False, "cpu", log=lambda m: None)


@pytest.mark.parametrize("cell", sorted({c for c, _ in CASES}))
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out.result["correct"] is True, out.result["check"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_fails_the_check(cell, fault):
    with faults.planted(fault):
        out = _run(cell)
    assert out.result["correct"] is False, out.result["check"]
