"""Guards of the PyTorch port: it never imports JAX, its kernel wrappers
never launch (or count) on CPU tensors, and chip_smoke.py refuses to run
without a CUDA device instead of falling back to the CPU."""

import importlib.util
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from _torch_util import to_np

from dvs_mcemvs_torch.kernels import binning, resample

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE_MODULES = [
    "dvs_mcemvs_torch", "dvs_mcemvs_torch.device", "dvs_mcemvs_torch.convert",
    "dvs_mcemvs_torch.mapper", "dvs_mcemvs_torch.graphs", "dvs_mcemvs_torch.pipeline",
    "dvs_mcemvs_torch.tracing",
    "dvs_mcemvs_torch.ops.se3", "dvs_mcemvs_torch.ops.trajectory",
    "dvs_mcemvs_torch.ops.camera", "dvs_mcemvs_torch.ops.depth_vector",
    "dvs_mcemvs_torch.ops.voting", "dvs_mcemvs_torch.ops.voting_hist",
    "dvs_mcemvs_torch.ops.grid", "dvs_mcemvs_torch.ops.extract",
    "dvs_mcemvs_torch.kernels._build", "dvs_mcemvs_torch.kernels.binning",
    "dvs_mcemvs_torch.kernels.resample", "dvs_mcemvs_torch.kernels.probes",
    "dvs_mcemvs_torch.kernels.scatter",
    "dvs_mcemvs_torch.utils.synthetic", "dvs_mcemvs_torch.utils.golden",
    "dvs_mcemvs_torch.ops.pointcloud", "dvs_mcemvs_torch.config",
    "dvs_mcemvs_torch.checkpoint", "dvs_mcemvs_torch.io", "dvs_mcemvs_torch.io.calib",
    "dvs_mcemvs_torch.io.events", "dvs_mcemvs_torch.io.poses", "dvs_mcemvs_torch.io.rosbag1",
    "dvs_mcemvs_torch.io.outputs", "dvs_mcemvs_torch.io.evstore",
    "dvs_mcemvs_torch.utils.writers", "dvs_mcemvs_torch.eval",
    "dvs_mcemvs_torch.eval.metrics", "dvs_mcemvs_torch.eval.dsec", "dvs_mcemvs_torch.cli",
    "dvs_mcemvs_torch.ops", "dvs_mcemvs_torch.kernels", "dvs_mcemvs_torch.utils",
    "dvs_mcemvs_torch.parallel", "dvs_mcemvs_torch.parallel.mesh",
    "dvs_mcemvs_torch.parallel.sharded",
]


def _clean_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return env


# The port's scripts: the CUDA probes and the ports of the JAX package's
# user scripts.
PORT_SCRIPTS = ["probe_gpu", "synthetic_demo_torch", "evaluate_dsec_torch",
                "convert_poses_torch", "golden_device_probe_torch",
                "bf_divergence_probe_torch", "roofline_torch", "profile_torch_chunk",
                "time_chunk_torch", "scaling_bench_torch"]


def test_port_never_imports_jax():
    code = ("import importlib, importlib.util, sys\n"
            f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
            "import chip_smoke, bench_torch\n"
            f"for name in {PORT_SCRIPTS!r}:\n"
            "    spec = importlib.util.spec_from_file_location(name, f'scripts/{name}.py')\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'dvs_mcemvs_tpu')))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_clean_env(),
                   check=True, timeout=120)


def test_slice_modules_cover_the_package():
    """Every module file of the port is in SLICE_MODULES, so the guard
    above holds each of them."""
    root = os.path.join(REPO, "dvs_mcemvs_torch")
    found = set()
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), REPO)[:-3].replace(os.sep, ".")
                found.add(rel[:-len(".__init__")] if rel.endswith(".__init__") else rel)
    assert found <= set(SLICE_MODULES), sorted(found - set(SLICE_MODULES))


@pytest.mark.parametrize("platform", ["", "cuda"])
def test_cli_needs_the_card(monkeypatch, tmp_path, platform):
    """`cli.main` with --platform= (or cuda) and no card raises: the CLI
    never falls back to the CPU unless --platform=cpu asks for it."""
    from dvs_mcemvs_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([f"--platform={platform}", "--calib_type=esim",
                  f"--out_path={tmp_path}/", "--bag_filename_left=e0.npz",
                  "--bag_filename_right=e1.npz", "--bag_filename_pose=p.txt"])


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_guard_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,argv", [
    ("synthetic_demo_torch", []),
    ("convert_poses_torch", ["{poses}", "{out}"]),
    ("golden_device_probe_torch", ["hist:g8,seg8,bf,pl", "--cfg", "SMALL"]),
    ("bf_divergence_probe_torch", ["--cfg", "SMALL"]),
    ("scaling_bench_torch", ["--out", "{out}"]),
], ids=["synthetic_demo", "convert_poses", "golden_device_probe", "bf_divergence_probe",
        "scaling_bench"])
def test_scripts_need_the_card(monkeypatch, tmp_path, name, argv):
    """Each script that runs the port raises without a card unless
    `--device cpu` asks for the CPU (convert_poses_torch.py, the quick one,
    then runs)."""
    poses = str(tmp_path / "poses.txt")
    np.savetxt(poses, [[0.0, 0, 0, 0, 0, 0, 0, 1], [1.0, 1, 0, 0, 0, 0, 0, 1]])
    argv = [a.format(poses=poses, out=str(tmp_path / "out.npz")) for a in argv]
    mod = _script(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(argv)
    if name == "convert_poses_torch":
        assert mod.main(argv + ["--device", "cpu"]) == 0
        np.testing.assert_array_equal(np.load(tmp_path / "out.npz")["t"], [0.0, 1.0])


@pytest.mark.parametrize("module,name", [
    ("ops.grid", "FUSION_NAMES"), ("utils.golden", "GOLDEN_NPZ"),
    ("utils.golden", "GOLDEN_SMALL_NPZ"), ("utils.golden", "GOLDEN_BENCH16_NPZ"),
])
def test_public_constants_match_jax(module, name):
    """The port's copies of the JAX package's public constants are equal to
    them (the golden anchors are the same files, reached from the port's
    own repository root)."""
    import importlib

    got = getattr(importlib.import_module(f"dvs_mcemvs_torch.{module}"), name)
    want = getattr(importlib.import_module(f"dvs_mcemvs_tpu.{module}"), name)
    assert got == want
    if name.startswith("GOLDEN"):
        assert os.path.isfile(got) and got.startswith(REPO)


def _bench_torch(monkeypatch):
    """bench_torch.py loaded afresh, cut to a small size."""
    spec = importlib.util.spec_from_file_location("_guard_bench_torch",
                                                  os.path.join(REPO, "bench_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in dict(WIDTH=128, HEIGHT=96, DIM_Z=16, N_EVENTS=16384, PACKET=512).items():
        monkeypatch.setattr(mod, k, v)
    return mod


def test_bench_torch_needs_the_card(monkeypatch):
    """bench_torch.py's main raises without a card: the bench has no CPU
    run."""
    mod = _bench_torch(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main()


def test_bench_torch_store_failure_raises(monkeypatch):
    """A native event store that fails fails the sustained loop: it does not
    go on from the numpy stream, as bench.py does."""
    mod = _bench_torch(monkeypatch)

    def broken(path, events):
        raise OSError("evs_create failed")

    monkeypatch.setattr(mod.evstore, "write_store", broken)
    with pytest.raises(OSError, match="evs_create"):
        mod.full_seq_sustained("hist:g4,seg4", 8, n_chunks=2, warmup=1, device="cpu")


def test_evaluate_dsec_needs_no_card(monkeypatch, tmp_path):
    """evaluate_dsec_torch.py scores depth files with numpy on the host:
    it runs with no card and has no --device flag."""
    run, gt = tmp_path / "run", tmp_path / "gt"
    run.mkdir()
    gt.mkdir()
    np.savetxt(run / "000.500000000depth_points_fused.txt", [[1, 2, 3.0], [3, 1, 2.5]])
    np.save(gt / "000000.npy", np.full((4, 5), 2.8))
    np.savetxt(tmp_path / "ts.txt", [0.5e6])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = _script("evaluate_dsec_torch")
    assert mod.main(["--run_dir", str(run), "--gt_timestamps", str(tmp_path / "ts.txt"),
                     "--gt_depth_npy_dir", str(gt), "--width", "5", "--height", "4"]) == 0
    with pytest.raises(SystemExit):
        mod.main(["--run_dir", str(run), "--gt_timestamps", "x", "--device", "cpu"])


def test_cpu_calls_launch_no_kernel():
    """A CPU tensor runs the plain version: no launch, no count."""
    for fn in (binning.bin_events, resample.banded_resample_sum,
               resample.banded_resample_fanin):
        fn.launches = 0
    rng = np.random.default_rng(30)
    hx = torch.as_tensor(rng.uniform(0, 31, (2, 64)), dtype=torch.float32)
    hy = torch.as_tensor(rng.uniform(0, 15, (2, 64)), dtype=torch.float32)
    hist = binning.bin_events(hx, hy, torch.ones(2, 64), hs=16, ws=32, binary_w=True,
                              out_dtype=torch.bfloat16)
    ones = torch.ones(2, 2)
    resample.banded_resample_sum(hist, ones, ones, ones, ones, out_h=8, out_w=16,
                                 blocked=False)
    resample.banded_resample_fanin(hist.reshape(1, 2, 16, 32), ones[None], ones[None],
                                   ones[None], ones[None], np.array([[0, 0]]),
                                   n_out=1, out_h=8, out_w=16)
    assert binning.bin_events.launches == 0
    assert resample.banded_resample_sum.launches == 0
    assert resample.banded_resample_fanin.launches == 0


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_cuda(tmp_path, where):
    """No CUDA device (or, alone in a directory, no port): a nonzero exit
    within seconds and no result line."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def test_chip_smoke_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke.py's phases at a tiny size on CPU tensors: every kernel
    comparison runs (plain version against itself), every spec form votes
    within the mass tolerance of the headline spec, the card-against-CPU
    check runs, and each phase refuses a path that launched no kernel."""
    sys.path.insert(0, REPO)
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, iters: (fn(), 0.0)[1])
    monkeypatch.setattr(chip_smoke, "cuda_graph_ms", lambda fn: (fn(), 0.0)[1])
    cpu = torch.device("cpu")
    res = chip_smoke.kernel_phase(cpu, G=4, E=1024, hs=64, ws=128, hs_dense=56, Ho=48,
                                  Wo=64, Z=12, S=4, K_sweep=2, K_wide=32, probe_h=176,
                                  probe_w=128, probe_g=4, iters=1, cap=(70_000, 4, 4, 8, 2),
                                  small=(26, 34))
    assert set(res) == {"bin_events", "bin_events_int8", "bin_events_dense",
                        "banded_resample_sum", "banded_resample_fanin", "smem_copy",
                        "block_step", "hbm_stream", "dyn_slice"}
    assert all(r["max_abs_err"] == 0.0 and r["bound_ms"] > 0 for r in res.values())
    assert res["hbm_stream"]["bound_by"] == "bytes"
    # No kernel's call syncs with the host any more (the int8 weight check
    # sets a device flag, kernel B's index tables are cached on the device):
    # every row is timed by CUDA graph, the loop timer beside it.
    assert sorted(n for n, r in res.items() if r["timer"] == "loop") == []
    assert all("loop_ms" in r for r in res.values())
    # The on-chip ceiling needs the card's SM clock: none on the CPU.
    assert all(r["ceiling_ms"] is None and r["ceiling_share"] is None for r in res.values())
    workload = chip_smoke.build_workload(cpu, n_events=16384, width=96, height=64,
                                         dim_z=20, n_pts=2000)
    with pytest.raises(AssertionError, match="not launched"):
        chip_smoke.chunk_phase(cpu, workload, runs=1)

    small = {spec.replace("g16", "g4").replace("seg16", "seg4"): needed
             for spec, needed in chip_smoke.SPEC_FORMS.items()}
    headline, _ = chip_smoke.run_chunk(workload, "hist:g4,seg4,bf,pl")
    masses = chip_smoke.check_dsis(headline, workload, "headline")
    out = chip_smoke.specs_phase(cpu, workload, masses,
                                 forms={spec: () for spec in small}, runs=1)
    assert set(out) == set(small)
    with pytest.raises(AssertionError, match="not launched"):
        chip_smoke.specs_phase(cpu, workload, masses, forms=small, runs=1)
    rows = chip_smoke.device_vs_cpu_phase(cpu)
    assert all(l1 == 0.0 for r in rows.values() for l1, _ in r)
    assert chip_smoke.dense_phase(cpu, workload, hs=136) == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        chip_smoke.probe_phase(min_time=0.01)


def test_chip_smoke_pipelines_rehearse_on_cpu(monkeypatch):
    """Phase 8's process_2/5 and full_seq steps at a tiny size on the CPU:
    the temporal vote mass is additive, RAM and store give the same chunks,
    and each step refuses a run that launched no kernel."""
    sys.path.insert(0, REPO)
    import chip_smoke

    cpu = torch.device("cpu")
    size = dict(width=96, height=64, dim_z=20, n_pts=2000)
    workload = chip_smoke.build_workload(cpu, n_events=16384, **size)
    headline, _ = chip_smoke.run_chunk(workload, "hist:g4,seg4,bf,pl")
    masses = chip_smoke.check_dsis(headline, workload, "headline")
    out = chip_smoke.temporal_phase(cpu, workload, masses, spec="hist:g4,seg4,bf,pl",
                                    runs=1, needed=())
    assert len(out) == 4
    with pytest.raises(AssertionError, match="not launched"):
        chip_smoke.temporal_phase(cpu, workload, masses, spec="hist:g4,seg4,bf,pl", runs=1)
    seq = chip_smoke.full_seq_phase(cpu, n_events=32768, runs=1, needed=(), **size)
    assert seq["RAM"][0] == seq["event store"][0] and len(seq["RAM"][0]) == 9
    with pytest.raises(AssertionError, match="not launched"):
        chip_smoke.full_seq_phase(cpu, n_events=32768, runs=1, **size)


def test_chip_smoke_presets_rehearse_on_cpu(monkeypatch, tmp_path):
    """Phase 9 and phase 6's sort check at a tiny size on the CPU: the MVSEC
    presets through the CLI on a bag (3 chunks each), the focus collapses
    and a 300-plane chunk against themselves, `sort` against `scatter`; and
    the presets refuse a run that launched no kernel."""
    sys.path.insert(0, REPO)
    import chip_smoke

    cpu = torch.device("cpu")
    size = dict(n_events=16384, width=96, height=64, n_pts=2000)
    workload = chip_smoke.build_workload(cpu, dim_z=20, **size)
    assert all(l1 < 1e-6 for l1, _ in chip_smoke.sort_vs_scatter_phase(workload))
    fused = chip_smoke.run_chunk(workload, "hist:g4,seg4,bf,pl")[0].fused_dsi
    out = chip_smoke.collapse_phase(cpu, fused, workload[0][0], runs=1)
    assert [equal for _, _, equal in out.values()] == [1.0] * 5
    assert chip_smoke.deep_chunk_phase(cpu, workload, needed=())["launches"]["bin_events"] == 0
    bag = dict(rig=chip_smoke.mvsec_rig(), n_pts=3000, n_samples=20,
               extra=("--dimZ=20", "--out_skip=0.5"), min_chunks=3)
    runs = chip_smoke.bag_phase(cpu, str(tmp_path / "a"), needed=(), **bag)
    assert [r["chunks"] for r in runs.values()] == [3, 3]
    with pytest.raises(AssertionError, match="not launched"):
        chip_smoke.bag_phase(cpu, str(tmp_path / "b"), **bag)


def test_chip_smoke_host_api_rehearses_on_cpu(tmp_path):
    """Phase 11's steps at a small size on the CPU (the card's side and the
    CPU's are the same plain versions, so every comparison is exact):
    vote_dsi against evaluate_dsi, the demo against itself, the grid
    extras, evaluate_dsec_torch.py against evaluate_sequence, the golden
    and butterfly probes; and vote_dsi refuses a run that launched no
    kernel."""
    sys.path.insert(0, REPO)
    import chip_smoke

    cpu = torch.device("cpu")
    workload = chip_smoke.build_workload(cpu, n_events=16384, width=96, height=64,
                                         dim_z=20, n_pts=2000)
    spec = "hist:g4,seg4,bf,pl"
    assert chip_smoke.vote_dsi_step(cpu, workload, spec, needed=()) == {
        "camera0": 0.0, "camera1": 0.0}
    with pytest.raises(AssertionError, match="not launched"):
        chip_smoke.vote_dsi_step(cpu, workload, spec)
    demo = chip_smoke.demo_step(cpu, specs=("scatter",), needed=())
    assert demo["scatter"][0] == 0
    res = chip_smoke.run_chunk(workload, spec)[0]
    grid = chip_smoke.grid_extras_step(cpu, res.fused_dsi,
                                       [res.dsis["camera0"], res.dsis["camera1"]])
    assert len(grid) == 16 and grid["collapse_min"][1] == 1.0
    report = chip_smoke.evaluate_dsec_step(cpu, str(tmp_path))
    assert report["frames_evaluated"] > 1
    rows = chip_smoke.golden_probe_step(cpu, "SMALL", specs=[spec], needed=())
    assert rows[0]["within1"] > 0.5
    bf = chip_smoke.bf_probe_step(cpu, "SMALL", n_events=8192)
    assert bf["bf"] == bf["flat"] == 0.0


def test_chip_smoke_programs_rehearse_on_cpu():
    """Phase 12's steps at a small size on the CPU, where no program is
    made: the comparison with eager refuses a run that replayed none, a
    returned DSI stays fresh, a chunk of refused int8 weights raises at its
    extraction (the fault flag the card reads), and the timing runs."""
    sys.path.insert(0, REPO)
    import chip_smoke

    cpu = torch.device("cpu")
    workload = chip_smoke.build_workload(cpu, n_events=16384, width=96, height=64,
                                         dim_z=20, n_pts=2000)
    with pytest.raises(AssertionError, match="programs replayed"):
        chip_smoke.program_vs_eager(cpu, workload, "hist:g4,seg4,bf,pl", needed=())
    chip_smoke.fresh_output_step(cpu, workload, spec="hist:g4,seg4,bf,pl")
    message = chip_smoke.refused_weights_step(cpu, workload, spec="hist:g4,seg4,bf,i8,pl")
    assert message == binning.WEIGHT_FAULTS[1]
    out = chip_smoke.program_timing_step(cpu, workload, spec="hist:g4,seg4,bf,pl", runs=1)
    assert set(out) == {"programs", "eager"}


@pytest.mark.parametrize("field,scale,agrees", [
    ("semi_dense_pixels", None, False),
    ("pointcloud_filtered", None, False),
    ("median_abs_err_m", 1.02, False),
    ("mean_abs_err_m", 0.98, False),
    ("median_abs_err_m", 1.005, True),
], ids=["pixels+1", "points+1", "median+2%", "mean-2%", "median+0.5%"])
def test_demo_step_holds_the_card_to_the_cpu(monkeypatch, field, scale, agrees):
    """Phase 11 (b): the card's counts must equal the CPU's and its errors
    lie within 1 % of the CPU's, relative (the demo's errors are under
    1 m, so a limit against max(|v|, 1) would pass a fifth of a plane)."""
    sys.path.insert(0, REPO)
    import chip_smoke

    cpu_report = {"backend": "scatter", "semi_dense_pixels": 2548, "median_abs_err_m": 0.0469,
                  "mean_abs_err_m": 0.1498, "pointcloud_filtered": 2512}
    card_report = dict(cpu_report)
    card_report[field] = card_report[field] + 1 if scale is None else card_report[field] * scale

    def run_demo(argv):
        return 0, card_report if argv[-1] == "cuda" else cpu_report, 0.0

    monkeypatch.setattr(chip_smoke, "_run_demo", run_demo)
    monkeypatch.setattr(chip_smoke, "read_counts", lambda: dict.fromkeys(chip_smoke.KERNELS_A_B, 1))
    card = types.SimpleNamespace(type="cuda")
    if agrees:
        assert chip_smoke.demo_step(card, specs=("scatter",))["scatter"][1] == card_report
    else:
        with pytest.raises(AssertionError, match=field):
            chip_smoke.demo_step(card, specs=("scatter",))


@pytest.mark.parametrize("entry", ["from_arrays", "golden_trajectories",
                                   "convert_trajectory"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """With no card and no device given, the entry points that place a
    trajectory raise; device="cpu" asks for the CPU."""
    from dvs_mcemvs_torch import convert
    from dvs_mcemvs_torch.ops import trajectory
    from dvs_mcemvs_torch.utils import golden

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ts = np.linspace(0.0, 1.0, 4)
    q = np.tile([1.0, 0.0, 0.0, 0.0], (4, 1))
    t = np.zeros((4, 3))
    if entry == "from_arrays":
        def build(**kw):
            return trajectory.from_arrays(ts, q, t, **kw)
    elif entry == "convert_trajectory":
        # The JAX package's Trajectory fields, read through numpy.
        poses = types.SimpleNamespace(q=q, t=t)
        jax_like = types.SimpleNamespace(ts=ts, poses=poses)

        def build(**kw):
            return convert.trajectory(jax_like, **kw)
    else:
        def build(**kw):
            return golden.golden_trajectories(golden.SMALL, **kw)[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        build()
    assert build(device="cpu").device.type == "cpu"


def test_kernel_index_arrays_are_row_major():
    """The resample kernel reads its (J, K) source indices row by row; a
    broadcast index array (the sweep form's) must reach it in that order."""
    src = np.broadcast_to(np.arange(4)[None, :], (20, 4))
    t = resample.host_index(src)
    assert t.dtype == torch.int32 and t.is_contiguous()
    np.testing.assert_array_equal(t.numpy().reshape(-1), np.tile(np.arange(4), 20))


def test_fanin_writes_each_plane_once():
    """Duplicate out_idx entries become one item per plane: its last writer."""
    blocks = torch.zeros(2, 1, 8, 16)
    blocks[0, 0, 2, 3] = 1.0
    blocks[1, 0, 5, 7] = 2.0
    z = torch.zeros(2, 3, 1)
    s = torch.ones(2, 3, 1)
    out = resample.banded_resample_fanin(blocks, s, z, s, z, np.array([[0, 1, 1], [2, 2, 2]]),
                                         n_out=4, out_h=8, out_w=16)
    out = to_np(out)
    assert out[0, 2, 3] == 1.0 and out[1, 2, 3] == 1.0 and out[2, 5, 7] == 2.0
    assert not out[3].any()      # a plane no item writes stays zero
