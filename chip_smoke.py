#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU: builds the
CUDA kernels, checks each against its plain PyTorch version at the main
path's shapes, drives the two-camera process_1 chunk at the headline size
through the three kernels, and gates the BENCH16 golden fixture.

    python3 chip_smoke.py        # needs one CUDA device and nvcc

Phases (each raises on failure, so the script exits non-zero):
  1. device  -- require CUDA; print the card's name and power limit;
  2. build   -- nvcc the sources in dvs_mcemvs_torch/csrc/;
  3. kernels -- kernel vs plain version on the card, error and CUDA-event
                times, at the headline shapes;
  4. chunk   -- process_1 + get_depth_map on 2 x 1 Mi events, 640x480x100,
                with the auto-selected spec; every kernel must have run;
  5. golden  -- BENCH16 (2 x 262,144 events) on the literal spec, scored
                against tests/golden/golden_dsec_g16.npz with BUDGET_BENCH16.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# The headline workload (bench.py:build_workload): DSEC dims, 1 Mi events
# per camera in 1024-event packets, 0.5 m of travel, 0.6 m baseline.
WIDTH, HEIGHT, DIM_Z = 640, 480, 100
N_EVENTS = 1_048_576
PACKET = 1024
HEADLINE_SPEC = "hist:g16,seg16,bf,pl"
# Histogram grid of that spec: (480 + 2*32) x (640 + 2*128), aligned to 64/128.
HS, WS = 576, 896
N_TIMED = 10

# Kernel vs plain version: both round to bf16 at the same points and sum in
# f32 in different orders, so a sum may land one bf16 step (2^-8) away, at
# most twice on one path (y stage, output cast): |k - p| <= 2^-6 |p| plus
# 1e-4 of the largest value.
RTOL, ATOL_OF_MAX = 2.0 ** -6, 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call of `fn`, by CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs error of `got` against `want`; raises beyond the tolerance."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs()
    scale = float(want.abs().max())
    excess = float((err - (RTOL * want.abs() + ATOL_OF_MAX * scale)).max())
    max_abs = float(err.max())
    mass = abs(float(got.double().sum() / want.double().sum()) - 1.0)
    log(f"  {name}: max_abs_err {max_abs:.6g} (max value {scale:.6g}), mass rel "
        f"{mass:.3g}; tolerance rtol {RTOL:.4g} + {ATOL_OF_MAX:g} x max -> "
        f"{'ok' if excess <= 0 else 'FAIL'}")
    if excess > 0 or mass > 1e-3:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_abs


# ---------------------------------------------------------------------------
# Phase 3: kernels at the headline shapes
# ---------------------------------------------------------------------------


def _merge_level_inputs(dev, G, hs, ws, rng):
    """The first radix-4 butterfly level: 4 ranges x G/4 nodes, each node
    summing 4 adjacent leaves under near-identity frame changes."""
    from dvs_mcemvs_torch.ops.voting_hist import _butterfly_radii

    radix = _butterfly_radii(16)[0]
    R, N = radix, G // radix
    src = (radix * np.arange(N)[None, :, None] + np.arange(radix)[None, None, :]
           ).repeat(R, 0).reshape(R * N, radix).astype(np.int32)
    shape = (R * N, radix)
    sy = torch.as_tensor(1.0 + rng.uniform(-2e-3, 2e-3, shape), dtype=torch.float32, device=dev)
    ty = torch.as_tensor(rng.uniform(-1.5, 1.5, shape), dtype=torch.float32, device=dev)
    tx = torch.as_tensor(rng.uniform(-3.0, 3.0, shape), dtype=torch.float32, device=dev)
    hist = torch.as_tensor(rng.gamma(0.3, 2.0, (G, hs, ws)), dtype=torch.float32,
                           device=dev).to(torch.bfloat16)
    return hist, sy, ty, tx, src


def _sweep_inputs(dev, S, K, Z, hs, ws, rng):
    """The fan-in plane sweep: S segments of K supergroups, Z planes with
    ragged segments padded by duplicate plane indices; sweep-like maps
    (scale ~1, translation ~ -pad + disparity)."""
    from dvs_mcemvs_torch.ops.voting_hist import PAD_X, PAD_Y

    bounds = [round(s * Z / S) for s in range(S + 1)]
    M = max(bounds[s + 1] - bounds[s] for s in range(S))
    out_idx = np.stack([np.minimum(bounds[s] + np.arange(M), bounds[s + 1] - 1)
                        for s in range(S)]).astype(np.int32)
    z_s = np.linspace(0.97, 1.03, Z)[out_idx][..., None] + rng.uniform(-1e-3, 1e-3, (S, M, K))
    disp = np.linspace(-60, 60, Z)[out_idx][..., None] + rng.uniform(-2, 2, (S, M, K))
    f32 = dict(dtype=torch.float32, device=dev)
    sy = torch.as_tensor(z_s, **f32)
    sx = torch.as_tensor(z_s + rng.uniform(-1e-4, 1e-4, z_s.shape), **f32)
    ty = torch.as_tensor(-PAD_Y * z_s + rng.uniform(-1, 1, z_s.shape), **f32)
    tx = torch.as_tensor(-PAD_X * z_s + disp, **f32)
    blocks = torch.as_tensor(rng.gamma(0.5, 4.0, (S, K, hs, ws)), **f32).to(torch.bfloat16)
    return blocks, sy, ty, sx, tx, out_idx


def empty_calls_launch_nothing(dev):
    """Calls with no events or no items launch no kernel, so their wrappers
    count no launch."""
    from dvs_mcemvs_torch.kernels import binning, resample

    wrappers = (binning.bin_events, resample.banded_resample_sum,
                resample.banded_resample_fanin)
    before = [fn.launches for fn in wrappers]
    f32 = dict(dtype=torch.float32, device=dev)
    none = torch.zeros((2, 0), **f32)
    hist = binning.bin_events(none, none, none, hs=64, ws=128, out_dtype=torch.bfloat16)
    maps = torch.zeros((0, 2), **f32)
    resample.banded_resample_sum(hist, maps, maps, maps, maps, out_h=48, out_w=64,
                                 blocked=False)
    resample.banded_resample_fanin(hist[None], *[maps[None]] * 4, np.zeros((1, 0), int),
                                   n_out=3, out_h=48, out_w=64)
    if [fn.launches for fn in wrappers] != before:
        raise AssertionError("an empty call counted a kernel launch")
    log("  empty calls: no launch counted")


def kernel_phase(dev, G=64, E=16384, hs=HS, ws=WS, Ho=HEIGHT, Wo=WIDTH, Z=DIM_Z,
                 S=16, K_sweep=4, K_wide=32, iters=10):
    """Each kernel against its plain version on `dev` at the given shapes.
    Returns {kernel name: {max_abs_err, ms, plain_ms}}."""
    from dvs_mcemvs_torch.kernels import binning, resample

    rng = np.random.default_rng(0)
    results = {}
    f32 = dict(dtype=torch.float32, device=dev)
    empty_calls_launch_nothing(dev)

    # Kernel A: binning, weighted (the padded main path) and 0/1 weights.
    hx = torch.as_tensor(rng.uniform(0, ws - 1, (G, E)), **f32)
    hy = torch.as_tensor(np.sort(rng.normal(hs / 2, hs / 5, (G, E)).clip(0, hs - 1)), **f32)
    errs = []
    for label, w_np in (("weighted", rng.uniform(0, 1, (G, E)) * (rng.uniform(size=(G, E)) > 0.1)),
                        ("binary", (rng.uniform(size=(G, E)) > 0.1).astype(np.float64))):
        w = torch.as_tensor(w_np, **f32)
        binary = label == "binary"
        got = binning.bin_events(hx, hy, w, hs=hs, ws=ws, binary_w=binary,
                                 out_dtype=torch.bfloat16)
        want = binning.bin_events_reference(hx, hy, w, hs, ws).to(torch.bfloat16)
        errs.append(compare(f"bin_events {label} ({G}x{E} -> {G}x{hs}x{ws} bf16)", got, want))
    w = torch.as_tensor(rng.uniform(0, 1, (G, E)), **f32)
    results["bin_events"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: binning.bin_events(hx, hy, w, hs=hs, ws=ws,
                                              out_dtype=torch.bfloat16), iters),
        plain_ms=cuda_ms(lambda: binning.bin_events_reference(hx, hy, w, hs, ws)
                         .to(torch.bfloat16), iters))

    # Kernel B through banded_resample_sum: one radix-4 merge level.
    hist, sy, ty, tx, src = _merge_level_inputs(dev, G, hs, ws, rng)
    items = np.arange(src.shape[0])
    src_t = torch.as_tensor(src, dtype=torch.long, device=dev)
    items_t = torch.as_tensor(items, device=dev)

    def merge():
        return resample.banded_resample_sum(hist, sy, ty, sy, tx, out_h=hs, out_w=ws,
                                            blocked=True, src=src, out_dtype=torch.bfloat16)

    def merge_plain():
        return resample.banded_resample_reference(
            hist, src_t, sy, ty, sy, tx, items_t, n_out=len(items), out_h=hs, out_w=ws,
            out_dtype=torch.bfloat16)

    err = compare(f"banded_resample_sum merge ({src.shape[0]}x{src.shape[1]}, "
                  f"{hs}x{ws} bf16)", merge(), merge_plain())
    results["banded_resample_sum"] = dict(max_abs_err=err, ms=cuda_ms(merge, iters),
                                          plain_ms=cuda_ms(merge_plain, 2))

    # Kernel B through banded_resample_fanin: the plane sweep, and K = 32.
    def fanin_case(label, S_, K_, Z_, n_plain):
        blocks, sy_, ty_, sx_, tx_, out_idx = _sweep_inputs(dev, S_, K_, Z_, hs, ws, rng)

        def run():
            return resample.banded_resample_fanin(blocks, sy_, ty_, sx_, tx_, out_idx,
                                                  n_out=Z_, out_h=Ho, out_w=Wo)

        # The plain version on the same items (one per plane, its last writer).
        sources, src_idx, maps, items_out = resample.fanin_items(
            blocks, sy_, ty_, sx_, tx_, out_idx)
        src_idx_t = torch.as_tensor(src_idx, device=dev)
        items_t = torch.as_tensor(items_out, dtype=torch.long, device=dev)

        def plain():
            return resample.banded_resample_reference(
                sources, src_idx_t, *maps, items_t, n_out=Z_, out_h=Ho, out_w=Wo)

        err_ = compare(f"banded_resample_fanin {label} ({S_}x{out_idx.shape[1]}x{K_} -> "
                       f"{Z_}x{Ho}x{Wo}, duplicates in out_idx)", run(), plain())
        return err_, cuda_ms(run, iters), cuda_ms(plain, n_plain)

    err, ms, plain_ms = fanin_case("sweep", S, K_sweep, Z, 2)
    err_wide, ms_wide, plain_wide = fanin_case(f"K={K_wide}", 2, K_wide, 8, 1)
    log(f"  banded_resample_fanin K={K_wide}: {ms_wide:.4f} ms, plain {plain_wide:.4f} ms")
    results["banded_resample_fanin"] = dict(max_abs_err=max(err, err_wide), ms=ms,
                                            plain_ms=plain_ms)
    for name, r in results.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms "
            f"(CUDA events, mean of {iters})")
    return results


# ---------------------------------------------------------------------------
# Phase 4: the two-camera chunk at the headline size
# ---------------------------------------------------------------------------


def build_workload(dev, n_events=N_EVENTS, width=WIDTH, height=HEIGHT, dim_z=DIM_Z,
                   n_pts=40_000):
    """The headline workload as bench.py:build_workload builds it (both
    cameras of the synthetic rig, each stream tiled to `n_events`)."""
    from dvs_mcemvs_torch.mapper import DsiShape, Events, make_mapper
    from dvs_mcemvs_torch.ops import se3, trajectory as trajmod
    from dvs_mcemvs_torch.ops.camera import PinholeCamera
    from dvs_mcemvs_torch.utils import synthetic

    cam = PinholeCamera(width=width, height=height, fx=width * 0.9, fy=width * 0.9,
                        cx=width / 2, cy=height / 2)
    rig = synthetic.SyntheticRig(cam=cam, baseline=0.6, travel=0.5, plane_depths=(4.0, 12.0))
    mapper = make_mapper(cam, DsiShape(dim_z=dim_z, min_depth=2.0, max_depth=40.0))
    rng = np.random.default_rng(1)
    pts = synthetic.make_scene(rig, rng, n_pts)
    events = []
    for cam_index in (0, 1):
        ev = synthetic.simulate_events(rig, pts, cam_index, n_samples=40, rng=rng)
        reps = -(-n_events // ev.num)
        events.append(Events(np.tile(ev.x, reps)[:n_events], np.tile(ev.y, reps)[:n_events],
                             np.sort(np.tile(ev.t, reps)[:n_events], kind="stable")))
    ts, q, p = synthetic.rig_poses(rig)
    traj0 = trajmod.from_arrays(ts, q, p, device=dev)
    T_1_0 = se3.SE3(torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev),
                    torch.tensor([-rig.baseline, 0.0, 0.0], device=dev))
    traj1 = trajmod.apply_right(traj0, se3.inverse(T_1_0))
    return [mapper, mapper], events, [traj0, traj1], rig


def chunk_phase(dev, workload, runs=N_TIMED):
    """One process_1 chunk with fresh launch counters, then `runs` timed
    chunks.  Returns (launch counts of the counted chunk, seconds list)."""
    from dvs_mcemvs_torch import mapper as mappermod, pipeline
    from dvs_mcemvs_torch.kernels import binning, resample
    from dvs_mcemvs_torch.ops import extract, voting_hist

    mappers, events, trajs, rig = workload
    m = mappers[0]
    n_ev = events[0].num
    spec = voting_hist.auto_backend_spec(
        rig.travel, n_ev // PACKET, m.vcam.fx, m.depth_vec.min_depth,
        m.depth_vec.max_depth, m.depth_vec.n)
    log(f"  auto-selected spec: {spec}")
    vopts = pipeline.VotingOptions(packet_size=PACKET, backend=spec, pad_policy="bucket")
    opts = extract.DepthMapOptions()

    def chunk():
        res = pipeline.process_1(mappers, events, trajs, 0.5, stereo_fusion=2, vopts=vopts)
        dm = mappermod.get_depth_map(m, res.fused_dsi, opts)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return res, dm

    wrappers = {"bin_events": binning.bin_events,
                "banded_resample_sum": resample.banded_resample_sum,
                "banded_resample_fanin": resample.banded_resample_fanin}
    for fn in wrappers.values():
        fn.launches = 0
    res, dm = chunk()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    log(f"  launches in one chunk: {launches}")

    Z, H, W = m.dsi_shape
    for name, dsi in [("fused", res.fused_dsi), *res.dsis.items()]:
        if tuple(dsi.shape) != (Z, H, W) or not bool(torch.isfinite(dsi).all()):
            raise AssertionError(f"DSI {name}: shape {tuple(dsi.shape)} or non-finite")
    for c, ev in enumerate(events):
        mass = float(res.dsis[f"camera{c}"].double().sum())
        log(f"  camera{c} vote mass {mass:.6g} ({mass / (ev.num * Z):.4f} per event-plane)")
        if not mass > 0:
            raise AssertionError(f"camera{c} cast no votes")
    mask = dm.mask > 0
    if not bool(torch.isfinite(dm.depth).all()) or not bool(mask.any()):
        raise AssertionError("depth map is non-finite or empty")
    d = dm.depth[mask]
    log(f"  depth map: {int(mask.sum())} masked pixels, depth {float(d.min()):.3f}.."
        f"{float(d.max()):.3f} m")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    if spec != HEADLINE_SPEC and dev.type == "cuda":
        raise AssertionError(f"auto spec {spec} is not the headline {HEADLINE_SPEC}")

    seconds = []
    for _ in range(runs):
        t0 = time.perf_counter()
        chunk()
        seconds.append(time.perf_counter() - t0)
    return launches, seconds


# ---------------------------------------------------------------------------
# Phase 5: the BENCH16 golden gate on the literal spec
# ---------------------------------------------------------------------------


def golden_phase(dev, cfg_name="BENCH16", spec=HEADLINE_SPEC, budget_name="BUDGET_BENCH16"):
    """Score the port on a golden fixture as bench.py:golden_gate does."""
    from dvs_mcemvs_torch import mapper as mappermod, pipeline
    from dvs_mcemvs_torch.ops import extract
    from dvs_mcemvs_torch.utils import golden

    cfg = getattr(golden, cfg_name)
    mappers, events, trajs, scene, ts_rv = golden.build_golden_fixture(cfg, device=dev)
    auto = golden.production_backend_spec(events, PACKET, cfg=cfg)
    if auto != spec:
        raise AssertionError(f"{cfg_name} auto spec {auto} != {spec}")
    vopts = pipeline.VotingOptions(packet_size=PACKET, backend=spec, pad_policy="bucket")
    res = pipeline.process_1(mappers, events, trajs, ts_rv, stereo_fusion=2, vopts=vopts)
    dm = mappermod.get_depth_map(mappers[0], res.fused_dsi, extract.DepthMapOptions())

    budget = getattr(golden, budget_name)
    out = dict(spec=spec, **golden.score(dm, res, scene, budget["confident_quantile"]))
    out["pass"] = bool(out["within1"] >= budget["frac_within_1_plane"]
                       and out["within2"] >= budget["frac_within_2_planes"]
                       and out["median_planes"] <= budget["median_err_planes"]
                       and out["gt_median_rel_err"] < budget["gt_median_rel_err"]
                       and max(out["cam_mass_rel"]) < budget["per_camera_mass_rel"])
    log(f"  golden {cfg_name}: {json.dumps(out)}")
    if not out["pass"]:
        raise AssertionError(f"golden gate failed: {out}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from dvs_mcemvs_torch.device import require_cuda
    from dvs_mcemvs_torch.kernels import _build, binning, resample

    t_start = time.perf_counter()
    dev = require_cuda()
    smi = nvidia_smi_line()
    log(f"[1/5] device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)

    log("[2/5] build (nvcc, sm_90a)")
    t0 = time.perf_counter()
    binning._library()
    resample._library()
    log(f"  built in {time.perf_counter() - t0:.2f} s")
    for name, (seconds, report) in _build.BUILD_INFO.items():
        lines = [ln.strip() for ln in report.splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}: nvcc {seconds:.2f} s; " + " | ".join(lines))

    log("[3/5] kernels vs plain versions at the headline shapes")
    results = kernel_phase(dev)

    log(f"[4/5] process_1 chunk: 2 x {N_EVENTS} events, {WIDTH}x{HEIGHT}x{DIM_Z}")
    workload = build_workload(dev)
    torch.cuda.reset_peak_memory_stats()
    launches, seconds = chunk_phase(dev, workload)
    med = float(np.median(seconds))
    log(f"  seconds per chunk (median of {len(seconds)} after a warm-up): {med:.6f} "
        f"[{', '.join(f'{s:.6f}' for s in seconds)}]; {2 * N_EVENTS / med / 1e6:.3f} Mev/s; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; {smi}")

    log("[5/5] golden gate: BENCH16 on the literal spec")
    golden_phase(dev)

    sources = {"bin_events": ("dvs_mcemvs_torch/csrc/binning.cu",
                              "dvs_mcemvs_tpu/kernels/binning_pallas.py:317"),
               "banded_resample_sum": ("dvs_mcemvs_torch/csrc/resample.cu",
                                       "dvs_mcemvs_tpu/kernels/resample_pallas.py:467"),
               "banded_resample_fanin": ("dvs_mcemvs_torch/csrc/resample.cu",
                                         "dvs_mcemvs_tpu/kernels/resample_pallas.py:361")}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
                "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"]}
               for name, (src, rep) in sources.items()]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
