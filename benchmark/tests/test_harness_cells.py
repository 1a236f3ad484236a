"""BENCHMARK.json against the contract, every piece loading by name, and the
harness's arithmetic: rates over all the work and all the time, the output
check's gaps, the profile's busy time, the per-layer readers."""

import json
import math
import os
import re

import numpy as np
import pytest
import torch

from benchmark import harness, judge, profiling
from benchmark.traffic import generate as traffic

SPEC = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
        reported = [m for m in SPEC["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in SPEC["per_layer"])
    for m in SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cells_load_by_name(cell):
    c = harness.load_cell(cell)
    assert c.config["name"] == cell.split(".")[0]
    assert set(c.limits) == {"dsi_l1", "fused_l1", "maps_off"}
    assert all(v > 0 for v in c.limits.values())
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]))


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_configs_run_the_exact_vote(config):
    """Every configuration runs the program's exact per-event vote, the
    semantics of the upstream presets that the reference holds it to."""
    cfg = json.load(open(os.path.join(harness.BENCH, "configs", config + ".json")))
    assert traffic.flags(cfg)["splat_backend"] == "scatter"


@pytest.mark.parametrize("name", [m["name"] for m in SPEC["per_layer"]])
def test_metric_readers(name):
    read = harness.metric_reader(name)
    trace = {"spans": {"window": [1.0, 3.0], "process": [10.0, 20.0], "extract": [2.0, 4.0]},
             "profile": {"busy_s": 0.25, "window_s": 1.0, "chunks": 10}}
    v = read(trace)
    assert v is not None and v > 0 and math.isfinite(v)
    empty = {"spans": {"window": [], "process": [], "extract": []}, "profile": None}
    assert read(empty) is None


def test_readers_arithmetic():
    trace = {"spans": {"window": [1.0, 3.0], "process": [10.0, 20.0], "extract": [2.0, 4.0]},
             "profile": {"busy_s": 0.25, "window_s": 1.0, "chunks": 10}}
    assert harness.metric_reader("window_ms.replay")(trace) == 2.0
    assert harness.metric_reader("process_ms.replay")(trace) == 15.0
    assert harness.metric_reader("extract_ms.replay")(trace) == 3.0
    assert harness.metric_reader("device_idle_share.replay")(trace) == pytest.approx(75.0)


def _rec(i, t_done, failed=False):
    r = harness.Record(i, 0.0)
    r.t_done, r.failed = t_done, failed
    return r


def test_rate_counts_all_work_over_all_time():
    recs = [_rec(i, 0.1 * (i + 1)) for i in range(10)] + [_rec(10, None, failed=True)]
    done = harness.completed(recs, end=0.55)
    assert len(done) == 5       # chunks 0-4 finished by 0.55 s; the rest late or failed


def test_gaps_at_the_votes_resolution():
    """A vote moved by one pixel, which blocks of pixels would hide, reads as
    twice its mass; the maps' gap counts mask and plane differences over the
    pixels masked on either side."""
    ref = torch.zeros(4, 8, 8)
    ref[1, 3, 3] = 2.0
    ref[2, 5, 5] = 2.0
    moved = torch.roll(ref, 1, dims=2)
    assert judge.rel_l1(ref, ref) == 0.0
    assert judge.rel_l1(moved, ref) == pytest.approx(2.0)
    depths = np.array([1.0, 2.0, 3.0, 4.0])
    rmaps = {"mask": torch.tensor([[1, 1, 0, 0]], dtype=torch.uint8),
             "depth": torch.tensor([[1.0, 2.0, 1.0, 1.0]])}
    pmaps = {"mask": np.array([[1, 1, 1, 0]], np.uint8), "depth": np.array([[1.0, 3.0, 1.0, 1.0]])}
    # Union of 3 pixels: one agrees, one differs in plane, one in mask.
    assert judge.maps_off(pmaps, rmaps, depths) == pytest.approx(2 / 3)
    row = {"dsi_l1": 1e-5, "fused_l1": 2e-5, "maps_off": 0.0}
    worst = judge.worst([row, dict(row, maps_off=0.5)])
    assert worst["maps_off"] == 0.5
    limits = {"dsi_l1": 1e-4, "fused_l1": 1e-4, "maps_off": 0.01}
    assert judge.verdict(row, limits) and not judge.verdict(worst, limits)
    assert not judge.verdict(dict(row, dsi_l1=float("nan")), limits)


def test_busy_time_merges_overlaps():
    busy, merged = profiling.busy_us([(0, 10), (5, 15), (20, 30), (30, 31)])
    assert busy == 26 and merged == [(0, 15), (20, 31)]
