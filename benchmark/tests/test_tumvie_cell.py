"""The TUM-VIE bike-easy-3 cell (`tumvie_bike_easy3.replay_3m`): its sound run
at a small size is correct on the CPU and each fault it can have fails its
check there; on the card, at the cell's own size, the program passes the
cell's limits and the bfloat16 control fails them.  Also the reader of
`device_busy_ms.replay`, new with the cell.

    python -m pytest benchmark/tests/test_tumvie_cell.py -q
    python -m pytest benchmark/tests/test_tumvie_cell.py -q -m card
"""

import pytest

from benchmark import calibrate, faults, harness, judge
from benchmark.tests import _cells

CELL = "tumvie_bike_easy3.replay_3m"
SEED = 2**31 + 4243
CARD_SEEDS = (4_100_000_011, 4_100_000_012, 4_100_000_013)


def _run():
    return harness.run(_cells.tiny(CELL), SEED, 0.5, False, "cpu", log=lambda m: None)


def test_sound_run_is_correct():
    out = _run()
    assert out.result["correct"] is True, out.result["check"]


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_fault_fails_the_check(fault):
    with faults.planted(fault):
        out = _run()
    assert out.result["correct"] is False, out.result["check"]


def test_device_busy_reader():
    read = harness.metric_reader("device_busy_ms.replay")
    assert read({"profile": {"busy_s": 0.25, "window_s": 1.0, "chunks": 10}}) == 25.0
    assert read({"profile": None}) is None
    assert read({"profile": {"busy_s": 0.0, "window_s": 0.0, "chunks": 0}}) is None


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_control_fails_where_the_program_passes(card):
    c = harness.load_cell(CELL)
    for seed in CARD_SEEDS:
        out = harness.run(c, seed, 2.0, False, card, log=lambda m: None, keep_refs=True)
        assert out.result["correct"] is True, (seed, out.result["check"])
        rows = calibrate.control_rows(out, card)
        assert not judge.verdict(judge.worst(rows), c.limits), (seed, judge.worst(rows))
