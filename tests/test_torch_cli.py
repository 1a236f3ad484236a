"""The PyTorch port's CLI (`python -m dvs_mcemvs_torch.cli`) against the JAX
package's CLI on the esim fixture, both on the CPU under the exact scatter
backend: the same files, the same depth maps, the same DSI dumps.  Each
CLI configuration runs once per module.  The same fixture from a ROS1 bag
is tests/test_torch_rosbag.py's."""

import glob
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
from _torch_util import assert_same_cli_artifacts

from dvs_mcemvs_tpu import cli as jcli
from dvs_mcemvs_tpu.utils import synthetic as jsynth
from dvs_mcemvs_torch import cli as tcli, pipeline as tpipe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET = os.path.join(REPO, "configs", "synthetic", "esim_stereo.conf")

RUNS = {
    "p1": ["--process_method=1", "--save_mono", "--save_dsi", "--save_conf_stats"],
    "p2": ["--process_method=2", "--temporal_fusion=4", "--num_intervals=2", "--save_dsi",
           "--nosave_pointcloud"],
    "p5": ["--process_method=5", "--temporal_fusion=2", "--num_intervals=4", "--save_dsi",
           "--late_fusion"],
    "fs": ["--process_method=1", "--full_seq", "--start_time_s=0", "--stop_time_s=1",
           "--duration=0.5", "--out_skip=0.4", "--nosave_pointcloud", "--save_dsi",
           "--save_workers=2"],
    # Two of the focus-measure collapses (local variance, difference of
    # Gaussians) in place of the argmax.
    "c0": ["--process_method=1", "--collapse_method=0", "--save_dsi", "--nosave_pointcloud"],
    "c4": ["--process_method=1", "--collapse_method=4", "--save_dsi", "--nosave_pointcloud"],
}


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("esim_fixture")
    rig = jsynth.esim_like_rig(travel=0.4)
    return str(d), jsynth.write_fixture(str(d), rig=rig, n_pts=1200, n_samples=25)


def _args(paths, out, extra):
    return [f"--flagfile={PRESET}", f"--bag_filename_left={paths['events0']}",
            f"--bag_filename_right={paths['events1']}",
            f"--bag_filename_pose={paths['poses']}", f"--out_path={out}/",
            "--dimZ=32", "--packet_size=256", "--platform=cpu"] + extra


@pytest.fixture(scope="module")
def runs(fixture_dir):
    """{run: (jax out dir, port out dir)} of every RUNS configuration,
    scatter backend on the CPU."""
    d, paths = fixture_dir
    out = {}
    for name, extra in RUNS.items():
        dirs = []
        for pkg, mod in (("jax", jcli), ("torch", tcli)):
            o = os.path.join(d, f"{pkg}_{name}")
            assert mod.main(_args(paths, o, extra + ["--splat_backend=scatter"])) == 0
            dirs.append(o)
        out[name] = tuple(dirs)
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_cli_writes_the_jax_artifacts(runs, name):
    """The same file set; every depth map agrees on >= 99 % of the pixels
    both masks keep; every DSI dump within relative L1 1e-4."""
    assert_same_cli_artifacts(*runs[name])


def test_cli_depth_on_the_planes(runs):
    """The fused map of process_1 lies on the fixture's 1.5 / 2.5 m planes."""
    _, tdir = runs["p1"]
    f = [x for x in os.listdir(tdir) if x.endswith("depth_points_fused.txt")][0]
    d = np.loadtxt(os.path.join(tdir, f))[:, 2]
    assert d.size > 100
    assert np.median(np.minimum(np.abs(d - 1.5), np.abs(d - 2.5))) < 0.2


def test_cli_full_seq_resumes_every_chunk(runs, fixture_dir, monkeypatch):
    """A second full_seq run over the same output resumes from the
    checkpoint: no chunk reaches the pipeline, and the run still exits 0."""
    d, paths = fixture_dir
    _, tdir = runs["fs"]
    files = os.listdir(tdir)
    assert len([f for f in files if f.endswith("depth_points_fused.txt")]) == 2
    assert {".events_0.evs", ".events_1.evs"} <= set(files)

    def refuse(*args, **kwargs):
        raise AssertionError("a resumed chunk was computed again")

    monkeypatch.setattr(tpipe, "process_1", refuse)
    assert tcli.main(_args(paths, tdir, RUNS["fs"] + ["--splat_backend=scatter"])) == 0


def test_cli_auto_spec_matches_jax(fixture_dir):
    """The port's auto spec is the JAX CLI's choice on its kernel engine
    (`auto_backend_spec(..., use_pl=True)`) for the same run, single-shot
    and full_seq."""
    from dvs_mcemvs_tpu.io import calib as jcalib, events as jevents, poses as jposes
    from dvs_mcemvs_tpu.mapper import DsiShape, make_mapper as jmake_mapper
    from dvs_mcemvs_tpu.ops.voting_hist import auto_backend_spec as jauto
    from dvs_mcemvs_torch.config import parse_args
    from dvs_mcemvs_torch.io import calib as tcalib, events as tevents, poses as tposes
    from dvs_mcemvs_torch.mapper import make_mapper as tmake_mapper

    _, paths = fixture_dir
    for extra in ([], ["--full_seq", "--start_time_s=0", "--stop_time_s=1",
                       "--duration=0.5", "--out_skip=0.4"]):
        cfg = parse_args(_args(paths, "unused", extra))
        # The JAX CLI's selection (dvs_mcemvs_tpu/cli.py, run), on its kernel engine.
        origin = jevents.TimeOrigin()
        jtraj = jcli._build_trajectories(
            jposes.read_poses(cfg.bag_filename_pose, origin=origin),
            jcalib.load_calibration(cfg.calib_type), 2)
        jev = [jevents.read_events(p, t_start=cfg.start_time_s, t_stop=cfg.stop_time_s,
                                   origin=origin)
               for p in (cfg.bag_filename_left, cfg.bag_filename_right)]
        shape = DsiShape(cfg.dimX, cfg.dimY, cfg.dimZ, cfg.fov_deg, cfg.min_depth,
                         cfg.max_depth)
        jm = jmake_mapper(jcalib.load_calibration(cfg.calib_type).cams[0], shape)
        pos = np.asarray(jtraj[0].poses.t)
        ts = np.asarray(jtraj[0].ts)
        total_t = float(ts[-1] - ts[0])
        span = min(cfg.duration if cfg.full_seq else cfg.stop_time_s - cfg.start_time_s,
                   total_t)
        travel = float(np.linalg.norm(np.diff(pos, axis=0), axis=1).sum())
        n_min = min(e.num for e in jev)
        if cfg.full_seq:
            whole = min(cfg.stop_time_s - cfg.start_time_s, total_t)
            n_min = max(1, int(n_min * (span / max(whole, span))))
        want = jauto(travel * span / total_t, max(1, n_min // cfg.packet_size),
                     float(jm.vcam.fx), cfg.min_depth, cfg.max_depth, cfg.dimZ, True)

        origin = tevents.TimeOrigin()
        ttraj = tcli._build_trajectories(
            tposes.read_poses(cfg.bag_filename_pose, origin=origin, device="cpu"),
            tcalib.load_calibration(cfg.calib_type), 2)
        tev = [tevents.read_events(p, t_start=cfg.start_time_s, t_stop=cfg.stop_time_s,
                                   origin=origin)
               for p in (cfg.bag_filename_left, cfg.bag_filename_right)]
        tm = tmake_mapper(tcalib.load_calibration(cfg.calib_type).cams[0], shape)
        got = tcli.auto_spec(cfg, ttraj, tev, tm)
        assert got == want and got.endswith(",pl")


def test_cli_runs_the_auto_spec_and_profiles(fixture_dir, tmp_path, caplog):
    """--splat_backend=auto (the default) runs the kernel engine's spec, on
    the kernels' plain versions here, --profile_dir writes a trace, and the
    first chunk's throughput is timed to the device's end
    (--timing_sync_every)."""
    _, paths = fixture_dir
    out = str(tmp_path / "auto")
    prof = str(tmp_path / "prof")
    with caplog.at_level(logging.INFO, logger="dvs_mcemvs_torch"):
        assert tcli.main(_args(paths, out, ["--process_method=1", "--nosave_pointcloud",
                                            f"--profile_dir={prof}"])) == 0
    assert any(f.endswith("depth_points_fused.txt") for f in os.listdir(out))
    assert os.path.getsize(os.path.join(prof, "trace.json")) > 0
    assert "Mev/s device-true" in caplog.text


def test_cli_timing_sync_every_drives_the_voting_sync(fixture_dir, tmp_path, monkeypatch):
    """full_seq with --timing_sync_every=2 waits for the device on chunks
    0, 2, ... and on no other; 0 never waits."""
    _, paths = fixture_dir
    real = tpipe.process_1
    for every, want in (("2", [True, False]), ("0", [False, False])):
        seen = []

        def spy(*args, vopts, **kwargs):
            seen.append(vopts.sync)
            return real(*args, vopts=vopts, **kwargs)

        monkeypatch.setattr(tpipe, "process_1", spy)
        out = str(tmp_path / f"every{every}")
        assert tcli.main(_args(paths, out, RUNS["fs"] + [
            "--splat_backend=scatter", "--save_workers=0", "--nocheckpoint",
            f"--timing_sync_every={every}"])) == 0
        assert seen == want


def test_cli_event_store_failure_fails_the_run(fixture_dir, tmp_path, monkeypatch):
    """--use_event_store never falls back to RAM: a store that cannot be
    built fails the run."""
    from dvs_mcemvs_torch.io import evstore

    def broken(*args, **kwargs):
        raise OSError("no compiler for the native store")

    monkeypatch.setattr(evstore, "write_store", broken)
    _, paths = fixture_dir
    with pytest.raises(OSError, match="native store"):
        tcli.main(_args(paths, str(tmp_path / "o"),
                        RUNS["fs"] + ["--splat_backend=scatter", "--use_event_store"]))


def _dsi_l1(a_dir, b_dir):
    a, b = (np.load(os.path.join(d, "dsi_fused.npy")).astype(np.float64)
            for d in (a_dir, b_dir))
    return np.abs(b - a).sum() / np.abs(a).sum()


@pytest.mark.parametrize("flag", ["--num_devices=2", "--coordinator", "--num_processes=1",
                                  "--process_id=0"])
def test_cli_runs_the_multi_rank_flags(runs, fixture_dir, tmp_path, monkeypatch, flag):
    """Each flag the port once refused now runs: --num_devices=2 spawns two
    CPU ranks (a subprocess here, so its ranks end with it); each process
    flag alone joins a one-rank group in this process, the values it leaves
    out read from the launcher's environment (MASTER_ADDR/MASTER_PORT,
    WORLD_SIZE, RANK).  The fused DSI is process_1's on one device (relative
    L1 1e-4) and the depth lies on the scene's planes."""
    
    _, paths = fixture_dir
    out = str(tmp_path / "o")
    extra = ["--process_method=1", "--save_dsi", "--nosave_pointcloud",
             "--splat_backend=scatter"]
    if flag == "--num_devices=2":
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.run([sys.executable, "-m", "dvs_mcemvs_torch.cli",
                               *_args(paths, out, extra + [flag])], env=env, cwd=REPO,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-4000:]
        assert "spawning 2 ranks (cpu)" in proc.stderr
    else:
        from dvs_mcemvs_torch.parallel.mesh import free_port

        port = str(free_port())
        env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port, "WORLD_SIZE": "1",
               "RANK": "0"}
        if flag == "--coordinator":
            flag = f"--coordinator=127.0.0.1:{port}"
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert tcli.main(_args(paths, out, extra + [flag])) == 0
        import torch.distributed as dist

        assert not dist.is_initialized()
    assert _dsi_l1(runs["p1"][1], out) < 1e-4
    f = [x for x in os.listdir(out) if x.endswith("depth_points_fused.txt")][0]
    d = np.loadtxt(os.path.join(out, f))[:, 2]
    assert np.median(np.minimum(np.abs(d - 1.5), np.abs(d - 2.5))) < 0.2


def test_cli_refuses_more_devices_than_cards(fixture_dir, tmp_path, monkeypatch):
    """--num_devices counts cards on the card platform: more than are
    present raises, as the JAX package's make_mesh does."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    _, paths = fixture_dir
    args = [a for a in _args(paths, str(tmp_path / "o"), ["--num_devices=2"])
            if a != "--platform=cpu"] + ["--platform=cuda"]
    with pytest.raises(ValueError, match="1 card"):
        tcli.main(args)


PRESETS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.conf"), recursive=True))


@pytest.mark.parametrize("preset", PRESETS,
                         ids=[os.path.relpath(p, os.path.join(REPO, "configs")) for p in PRESETS])
def test_every_preset_is_ported(preset):
    """Every preset of configs/ (44 of them read ROS1 bags) parses as the JAX
    CLI parses it; the port refuses none of them."""
    from dvs_mcemvs_tpu import config as jconfig
    from dvs_mcemvs_torch import config as tconfig

    argv = [f"--flagfile={preset}"]
    cfg = tconfig.parse_args(argv)
    assert tconfig.config_to_flagfile(cfg) == jconfig.config_to_flagfile(jconfig.parse_args(argv))


def test_cli_refuses_unknown_platform(fixture_dir, tmp_path):
    _, paths = fixture_dir
    with pytest.raises(ValueError, match="--platform"):
        tcli.main(_args(paths, str(tmp_path / "o"), ["--platform=tpu"]))
