"""The port's CLI on more than one rank, on the CPU: `--num_devices=2` (two
spawned gloo ranks) and two processes under `--coordinator`,
`--num_processes=2`, `--process_id`, against the JAX CLI's single-process
`--num_devices=2` artifacts (`_torch_util.assert_same_cli_artifacts`), and a
two-process full_seq resume in which rank 0's ledger decides which chunks
every rank skips.

The fixture is tests/test_multihost.py's: each camera's stream cut to 8,192
events, a whole number of two-process quanta (2 x 256 events), so the
processes' slices need no padding and vote the packets of a single-process
run; only the order of the all-reduce's sums differs.  Every CLI run here is
a subprocess in its own session with one torch thread, killed with its
ranks when it passes its deadline.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
from _torch_util import assert_same_cli_artifacts
from test_multihost import _cli_args, _load_depth_points, _write_cli_fixture

from dvs_mcemvs_tpu import cli as jcli
from dvs_mcemvs_torch.parallel.mesh import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {
    "p1": ["--process_method=1", "--save_dsi"],
    "p2": ["--process_method=2", "--num_intervals=2", "--temporal_fusion=4", "--save_dsi"],
    "fs": ["--full_seq", "--start_time_s=0", "--stop_time_s=1.0", "--duration=0.3",
           "--out_skip=0.25", "--save_dsi"],
}
TIMEOUT_S = 120


def _launch(argvs, log_dir, timeout=TIMEOUT_S):
    """Run `python -m dvs_mcemvs_torch.cli` once per argv, all at once; fail
    with the logs when one exits non-zero or the deadline passes (every
    process group is killed then).  Returns the logs."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    logs = [os.path.join(log_dir, f"rank{i}.log") for i in range(len(argvs))]
    procs = []
    for argv, path in zip(argvs, logs):
        with open(path, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "dvs_mcemvs_torch.cli", *argv], env=env, cwd=REPO,
                stdout=f, stderr=subprocess.STDOUT, start_new_session=True))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.wait(timeout=30)
    text = [open(path).read() for path in logs]
    for p, t in zip(procs, text):
        assert p.returncode == 0, f"exit {p.returncode}:\n{t[-4000:]}"
    return text


def _two_processes(paths, pose, out, extra, log_dir):
    port = free_port()
    return _launch([_cli_args(paths, pose, out, extra + [
        f"--coordinator=127.0.0.1:{port}", "--num_processes=2", f"--process_id={p}"])
        for p in range(2)], log_dir)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("multihost")
    paths, pose = _write_cli_fixture(d, n_events=8192)
    return d, paths, pose


@pytest.fixture(scope="module")
def jax_runs(fixture):
    """The JAX CLI's single-process --num_devices=2 run of every RUNS entry."""
    d, paths, pose = fixture
    out = {}
    for name, extra in RUNS.items():
        out[name] = str(d / f"jax_{name}")
        assert jcli.main(_cli_args(paths, pose, out[name], extra + ["--num_devices=2"])) == 0
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_num_devices_matches_jax(fixture, jax_runs, tmp_path, name):
    """--num_devices=2: two spawned ranks holding the whole chunk, each
    voting its z-block (scatter: mesh (1, 2)), as the JAX CLI's mesh."""
    _, paths, pose = fixture
    out = str(tmp_path / "out")
    _launch([_cli_args(paths, pose, out, RUNS[name] + ["--num_devices=2"])], str(tmp_path))
    assert_same_cli_artifacts(jax_runs[name], out)


@pytest.mark.parametrize("name", ["p1", "p2"])
def test_two_processes_match_jax(fixture, jax_runs, tmp_path, name):
    """Two processes, each feeding its half of every chunk (mesh (2, 1)):
    rank 0 writes what the JAX CLI's single-process run writes; rank 1
    writes nothing beside it."""
    _, paths, pose = fixture
    out = str(tmp_path / "out")
    logs = _two_processes(paths, pose, out, RUNS[name], str(tmp_path))
    assert "mesh (event=2, plane=1)" in logs[0] and "backend gloo" in logs[0]
    assert_same_cli_artifacts(jax_runs[name], out, launch_flags=True)


def test_two_process_full_seq_resume(fixture, tmp_path):
    """Rank 0's ledger marks chunk 0 done and its peer holds none: both skip
    chunk 0 (otherwise their per-chunk collectives would pair up wrongly or
    hang), and the resumed chunks equal an uninterrupted two-process run's."""
    _, paths, pose = fixture
    out_ref = str(tmp_path / "ref")
    _two_processes(paths, pose, out_ref, RUNS["fs"], str(tmp_path))
    ledger = json.load(open(os.path.join(out_ref, "checkpoint.json")))
    assert len(ledger["done"]) >= 2, "the fixture made too few chunks"

    out_res = str(tmp_path / "resumed")
    os.makedirs(out_res)
    with open(os.path.join(out_res, "checkpoint.json"), "w") as f:
        json.dump(dict(ledger, done=[0], meta={"0": ledger["meta"]["0"]}), f)
    logs = _two_processes(paths, pose, out_res, RUNS["fs"], str(tmp_path))
    assert "resume sync: 1 chunks done per rank 0's ledger" in logs[1]
    assert all("chunk 0 @ ts=" in t and "already complete; skipped" in t for t in logs)

    def fused(d):
        return sorted(f for f in os.listdir(d) if f.endswith("depth_points_fused.txt"))

    ref_files = fused(out_ref)
    assert fused(out_res) == ref_files[1:]
    for f in ref_files[1:]:
        a = _load_depth_points(os.path.join(out_ref, f))
        b = _load_depth_points(os.path.join(out_res, f))
        assert a.keys() == b.keys(), f
        assert all(abs(a[k] - b[k]) < 1e-6 for k in a), f
        np.testing.assert_array_equal(np.load(os.path.join(out_ref, f.replace(
            "depth_points_fused.txt", "dsi_fused.npy"))), np.load(os.path.join(
                out_res, f.replace("depth_points_fused.txt", "dsi_fused.npy"))))
