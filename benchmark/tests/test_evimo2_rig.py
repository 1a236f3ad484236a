"""The EVIMO2 trinocular fixture (`evimo2/`): three 640x480 radtan cameras
with distinct K, rotated extrinsics, a hand-eye transform and one shared P,
through `harness.Program` and `harness.Reference`.  At a small size on the
CPU the program's judged chunks lie within dsi_l1 and fused_l1 1e-3 and
maps_off 0.02 of the reference, and the faults it can have fail its check
(its three windows differ, so a stale chunk is one); on the card, at its own size, `run.py --spec` runs it 2 s a seed
and every judged chunk is printed.

    python -m pytest benchmark/tests/test_evimo2_rig.py -q
    python -m pytest benchmark/tests/test_evimo2_rig.py -q -m card -s
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import faults, harness
from benchmark.tests import _cells

SEED = 2**31 + 4244
BOUNDS = {"dsi_l1": 1e-3, "fused_l1": 1e-3, "maps_off": 0.02}
CARD_SEEDS = (4_100_000_031, 4_100_000_032)


def _run(seed=SEED):
    return harness.run(_cells.tiny(_cells.evimo2()), seed, 0.5, False, "cpu",
                       log=lambda m: None)


def test_fixture_is_a_three_camera_distorted_rig():
    c = _cells.evimo2()
    cams = c.config["rig"]["cameras"]
    assert len(cams) == 3 and {cam["distortion"] for cam in cams} == {"radtan"}
    assert len({tuple(cam["K"]) for cam in cams}) == 3
    assert c.limits == BOUNDS


@pytest.mark.parametrize("seed", [SEED, 2**33 + 17])
def test_program_meets_the_reference(seed):
    out = _run(seed)
    assert len(out.rows) == harness.JUDGED_CHUNKS
    for row in out.rows:
        assert all(row[k] <= v for k, v in BOUNDS.items()), row
    assert out.result["correct"] is True, out.result["check"]
    prog = out.judged[0].res
    assert sorted(k for k in prog.dsis if k[6:].isdigit()) == ["camera0", "camera1",
                                                              "camera2"]


def test_program_meets_the_reference_with_rectifying_rotations():
    """R on cameras 1 and 2 (the slider rig's kind): the program's
    rectification and the reference's rays agree."""
    c = _cells.tiny(_cells.evimo2())
    for i, deg in ((1, 1.5), (2, -2.0)):
        a = np.deg2rad(deg)
        c.config["rig"]["cameras"][i]["R"] = [[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                                              [0, np.sin(a), np.cos(a)]]
    out = harness.run(c, SEED, 0.5, False, "cpu", log=lambda m: None)
    assert out.rows
    for row in out.rows:
        assert all(row[k] <= v for k, v in BOUNDS.items()), row


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_fault_fails_the_check(fault):
    with faults.planted(fault):
        out = _run()
    assert out.result["correct"] is False, out.result["check"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_fixture_runs_on_the_card(card):
    """Each seed is a run of `run.py --spec` in a process of its own, as the
    benchmark runs a cell: a third run in one process fails in the port's
    page-lock registry with these small streams (PERF.md, Open questions)."""
    for seed in CARD_SEEDS:
        out = subprocess.run(
            [sys.executable, os.path.join(harness.BENCH, "run.py"), "--spec",
             os.path.join(_cells.EVIMO2, "spec.json"), "--workload", _cells.CELL,
             "--seed", str(seed), "--seconds", "2", "--trace", "0"],
            capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
        for line in out.stderr.splitlines():
            if "judged chunk" in line or line.startswith("check "):
                print(f"seed {seed}: {line}")
        assert out.returncode == 0, out.stderr[-3000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"seed {seed}: {result['metrics']} {result['device']}")
        assert result["correct"] is True, (seed, result["check"])
