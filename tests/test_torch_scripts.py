"""The port's user scripts (scripts/*_torch.py) against the JAX package's
scripts, on the CPU.

- synthetic_demo_torch.py: the same events as the JAX demo's
  `simulate_events` at the same seed, and the same report, verdict and
  exit code as `python scripts/synthetic_demo.py --backend SPEC` run in
  this test under `scatter` and two histogram specs.  The JAX demo takes
  20-45 s a spec on the CPU (its Pallas kernels in interpret mode), so
  the three runs start together in subprocesses and the port's runs go
  on meanwhile.
- convert_poses_torch.py: the same output bytes as scripts/convert_poses.py
  for TUM, npz and bag input (an npz is compared member by member: the zip
  records hold the write time).
- the two viewers, which import neither package, on the port CLI's DSI
  dump and point cloud, headless.
- golden_device_probe_torch.py and bf_divergence_probe_torch.py on the CPU
  at a small size.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest

from dvs_mcemvs_torch.utils import synthetic as tsynth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The demo's specs: the exact scatter, and the histogram spec of the CPU
# tests and of chip_smoke.py phase 11 (b).
DEMO_SPECS = ["scatter", "hist:g8,seg8,bf,pl", "hist:g16,seg16,bf,pl"]
DEMO_TIMEOUT_S = 600


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _main(mod, argv):
    """A script's main(argv) in this process: (exit code, stdout lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue().splitlines()


def test_demo_events_match_jax():
    jdemo = _load("synthetic_demo")
    tdemo = _load("synthetic_demo_torch")
    cam = tdemo.PinholeCamera(width=128, height=96, fx=120.0, fy=120.0, cx=64.0, cy=48.0)
    got = tdemo.rig_events(np.random.default_rng(tdemo.SEED), cam, 0.20)
    rng = np.random.default_rng(42)
    pts = jdemo.make_scene(rng)
    t_samp = np.linspace(0.05, 0.95, 40)
    for off, ev in zip((0.0, 0.20), got):
        pos = np.stack([0.40 * t_samp + off, 0 * t_samp, 0 * t_samp], axis=-1)
        want = jdemo.simulate_events(pts, cam, pos, t_samp, rng)
        for g, w in zip(ev, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _demo_result(rc, lines):
    """(report, verdict, exit code) of a demo's standard output."""
    return json.loads(next(ln for ln in lines if ln.startswith("{"))), lines[-1], rc


@pytest.fixture(scope="module")
def jax_demos():
    """scripts/synthetic_demo.py (the JAX package) under each spec of
    DEMO_SPECS, all started at once: {spec: subprocess}."""
    procs = {spec: subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "synthetic_demo.py"), "--backend", spec],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu")) for spec in DEMO_SPECS}
    yield procs
    for proc in procs.values():
        proc.kill()
        proc.wait()


@pytest.mark.parametrize("backend", DEMO_SPECS)
def test_demo_prints_the_jax_report(jax_demos, backend):
    rc, lines = _main(_load("synthetic_demo_torch"), ["--backend", backend, "--device", "cpu"])
    got = _demo_result(rc, lines)
    proc = jax_demos[backend]
    out, err = proc.communicate(timeout=DEMO_TIMEOUT_S)
    assert proc.returncode in (0, 1), err[-2000:]
    want = _demo_result(proc.returncode, out.splitlines())
    assert got == want
    assert want[1] == ("PASS" if want[2] == 0 else "FAIL")


@pytest.fixture(scope="module")
def pose_files(tmp_path_factory):
    """One trajectory as TUM text (unsorted), npz and a PoseStamped bag."""
    d = tmp_path_factory.mktemp("poses")
    rng = np.random.default_rng(50)
    n = 25
    ts = rng.uniform(100.0, 103.0, n)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    p = rng.normal(size=(n, 3))
    tum = str(d / "poses.txt")
    with open(tum, "w") as f:
        f.write("# t x y z qx qy qz qw\n")
        for i in range(n):
            f.write("%.9f %.6f %.6f %.6f %.9f %.9f %.9f %.9f\n" % (
                ts[i], *p[i], *q[i, [1, 2, 3, 0]]))
    npz = str(d / "poses.npz")
    np.savez(npz, t=ts, q=q, p=p)
    bag = str(d / "poses.bag")
    order = np.argsort(ts)
    tsynth.write_rosbag(bag, [("/pose", "geometry_msgs/PoseStamped", ts[i],
                               tsynth.pose_msg("geometry_msgs/PoseStamped", ts[i], p[i], q[i]))
                              for i in order])
    return {"tum": tum, "npz": npz, "bag": bag}


def _convert_jax(argv):
    mod = _load("convert_poses")
    old = sys.argv
    sys.argv = ["convert_poses.py", *argv]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            mod.main()
    finally:
        sys.argv = old


def _same_bytes(a, b):
    if a.endswith(".npz"):
        with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
            assert za.namelist() == zb.namelist()
            for name in za.namelist():
                assert za.read(name) == zb.read(name), name
    else:
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


@pytest.mark.parametrize("src", ["tum", "npz", "bag"])
@pytest.mark.parametrize("dst", [".npz", ".txt"])
def test_convert_poses_writes_the_jax_bytes(tmp_path, pose_files, src, dst):
    extra = ["--topic", "/pose"] if src == "bag" else []
    want, got = str(tmp_path / f"jax{dst}"), str(tmp_path / f"port{dst}")
    _convert_jax([pose_files[src], want, *extra])
    rc, lines = _main(_load("convert_poses_torch"),
                      [pose_files[src], got, *extra, "--device", "cpu"])
    assert rc == 0 and lines == [f"wrote {got} (25 poses)"]
    _same_bytes(want, got)


@pytest.fixture(scope="module")
def cli_outputs(tmp_path_factory):
    """The port CLI's process_1 outputs on the esim fixture (CPU)."""
    from dvs_mcemvs_torch import cli

    d = tmp_path_factory.mktemp("cli")
    paths = tsynth.write_fixture(str(d / "data"), n_samples=10)
    out = str(d / "out")
    flagfile = os.path.join(REPO, "configs", "synthetic", "esim_stereo.conf")
    rc = cli.main([f"--flagfile={flagfile}", f"--bag_filename_left={paths['events0']}",
                   f"--bag_filename_right={paths['events1']}",
                   f"--bag_filename_pose={paths['poses']}", "--platform=cpu",
                   f"--out_path={out}/", "--dimZ=24", "--save_dsi"])
    assert rc == 0
    return out


@pytest.mark.parametrize("viewer,arg,extra", [
    ("visualize_dsi", "dsi_fused.npy", ["--mode", "volume", "--max-points", "2000"]),
    ("visualize_pointcloud", "pointcloud.pcd", []),
], ids=["dsi", "pointcloud"])
def test_viewers_read_the_port_outputs(cli_outputs, tmp_path, viewer, arg, extra):
    png = str(tmp_path / "view.png")
    env = dict(os.environ, MPLBACKEND="Agg")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", f"{viewer}.py"),
                           os.path.join(cli_outputs, arg), "--out", png, *extra],
                          capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert os.path.getsize(png) > 0


def test_golden_probe_on_the_cpu():
    rc, lines = _main(_load("golden_device_probe_torch"),
                      ["hist:g8,seg8,bf,pl", "--cfg", "SMALL", "--device", "cpu"])
    row = json.loads(lines[-1])
    assert rc == 0 and lines[0] == "device=cpu cpu"
    assert row["spec"] == "hist:g8,seg8,bf,pl" and 0.5 < row["within1"] <= row["within2"] <= 1
    assert max(row["cam_mass_rel"]) < 0.01


def test_bf_probe_on_the_cpu(tmp_path):
    mod = _load("bf_divergence_probe_torch")
    npz = str(tmp_path / "cpu.npz")
    rc, lines = _main(mod, ["--device", "cpu", "--cfg", "SMALL", "--n_events", "16384",
                            "--out", npz])
    assert rc == 0 and lines[-1].startswith("cpu: bf-vs-flat rel-L1")
    d = np.load(npz)
    assert str(d["device"]) == "cpu" and d["bf"].shape == d["flat"].shape == (50, 240, 320)
    rc, lines = _main(mod, ["--compare", npz, npz])
    assert rc == 0 and lines[0].startswith("bf   : cpu-vs-cpu rel-L1 0.000e+00")
