"""On the card, at each cell's own size: the program's judged chunks pass
the cell's limits and the control fails them.  The control is the plain
reference computed with its DSIs in bfloat16 (the nearest precision below
the presets' float32), put in the program's place on the same chunks.

    python -m pytest benchmark/tests/test_card_control.py -q -m card
"""

import pytest

from benchmark import calibrate, harness, judge

SEEDS = (4_100_000_001, 4_100_000_002, 4_100_000_003)
CELLS = ("dsec_zurich04.replay_dense", "mvsec_flying1_athc.replay")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(card, cell):
    c = harness.load_cell(cell)
    for seed in SEEDS:
        out = harness.run(c, seed, 2.0, False, card, log=lambda m: None, keep_refs=True)
        assert out.result["correct"] is True, (seed, out.result["check"])
        rows = calibrate.control_rows(out, card)
        assert not judge.verdict(judge.worst(rows), c.limits), (seed, judge.worst(rows))
