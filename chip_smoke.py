#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU: builds the
CUDA kernels, checks each against its plain PyTorch version at the main
path's shapes, drives the two-camera process_1 chunk at the headline size
through the kernels under every voting backend and histogram spec form,
gates the BENCH16 golden fixture, runs the CLI on presets from a ROS1
bag, and drives the sharded step and the CLI on more than one rank.

    python3 chip_smoke.py        # needs one CUDA device and nvcc

Phases (each raises on failure, so the script exits non-zero):
  1. device  -- require CUDA; print the card's name and power limit;
  2. build   -- nvcc the sources in dvs_mcemvs_torch/csrc/, all at once;
  3. kernels -- kernel vs plain version on the card, error and times (the
                device alone, by CUDA graph; a loop of Python calls between
                CUDA events beside it), at the headline shapes: binning (f32 taps and int8,
                windowed and dense grids; the ss2 grid, events on every band
                edge, 64-bit int8 sums, a ragged 552 x 830 grid; its launch
                plans, cluster occupancy and ptxas report), both resample
                call forms and the edges of the resample kernel's two paths
                (scale 0.3, bands off the source edge, a ragged output), the
                call forms of the one-hot engine's specs (binning on the
                unaligned 544-row grid and on 1088 x 1792; kernel B's sweep
                from 544-row sources, the ss2 flat merge, a sweep into
                260 x 346), the four platform probes (hbm_stream also on
                ragged streams, block_step at 1, 300 and 4,096 blocks,
                smem_copy and dyn_slice on ragged shapes, with the on-chip
                ceiling of these two);
  4. chunk   -- process_1 + get_depth_map on 2 x 1 Mi events, 640x480x100,
                with the auto-selected spec; every kernel must have run;
  5. golden  -- BENCH16 (2 x 262,144 events) on the literal spec, scored
                against tests/golden/golden_dsec_g16.npz with BUDGET_BENCH16;
                also scored (not gated) under int8 binning and the flat merge;
  6. specs   -- the headline chunk once under each further spec form (the
                one-hot engine's `hist:g16,ss2,seg10`, `hist` and
                `hist_exact`, and `sort`, too), with the kernels each must
                reach, its vote mass against the headline spec's, seconds
                per chunk and peak memory; `sort` against the exact scatter;
                then a small chunk on the card against the same chunk on the
                CPU;
  7. paths   -- the dense binning form (a grid whose height is not a
                multiple of 64) and the platform probes (scripts/probe_gpu.py),
                each with the launch counts of its own run;
  8. pipelines -- process_2 and process_5 on the headline chunk (4
                sub-intervals, AM and HM temporal fusion; vote mass additive
                under AM), full_seq over 2 x 4 Mi events (about 9 chunks) from
                RAM and from the native event store, the multi-frame golden
                gate on the FULL fixture, and the CLI itself
                (`dvs_mcemvs_torch.cli.main` on the esim fixture: process
                1, 2, 5 and full_seq with checkpoint resume); each step with
                its launches per kernel, seconds, Mev/s and peak memory;
  9. presets -- two MVSEC presets (process_1 and process_2, full_seq) through
                the CLI on a ROS1 bag of the synthetic rig at 346 x 260, 2 Mi
                events a camera over 2 s, read whole into RAM (bag read rate,
                chunks/s, launches, peak memory, depth on the planes); the
                focus collapses 0-4
                on the headline fused DSI, the card against the CPU; one
                process_1 chunk of phase 4's events at 300 planes (the
                sort-path median) against the CPU's extraction.
 10. distributed -- the sharded step (dvs_mcemvs_torch.parallel) on the
                headline chunk, against phase 4's process_1 + get_depth_map
                (fused-DSI relative L1 < 1e-3, vote mass within 1e-3, depth
                indices equal on >= 99.9 % of the pixels, kernels A and B
                launched from the shard body): (a) one rank over NCCL;
                (b) two spawned ranks sharing the card over gloo, on meshes
                (2, 1) (event shards) and (1, 2) (plane shards, 50 planes a
                rank, held per plane block), with the time of the staged
                all-reduce of a fused-DSI-sized tensor; in (a) and on each
                mesh of (b), each rank's step programs (CUDA graphs cut at
                the collectives) against the same step under
                `mapper.eager()`: the full step under the headline spec,
                its int8 form and `scatter`, the voting step under the
                headline spec (hist specs equal to the bit, `scatter`
                within phase 3's tolerance, depth indices equal on
                >= 99.9 %, a replay's launch counts equal to eager's, graph
                launches a step equal to its compute segments), a result
                unchanged by the next replay, refused weights raising the
                binary check in the full step and the int8 check at the
                caller's fault read after the voting step, seconds a chunk
                of both in turns with one profiled chunk of each, capture
                seconds; (c) the CLI as two
                processes (--coordinator, --num_processes=2, --process_id) on
                the esim fixture under process_method 1 and 2, against the
                same run in one process.
 11. host API and scripts -- (a) `voting.vote_dsi` on the headline chunk's
                warped packets under the headline spec, equal to
                `mapper.evaluate_dsi` (kernels A and B launched); (b) the
                synthetic demo (scripts/synthetic_demo_torch.py) in this
                process under the headline spec and `scatter`, each against
                the same demo on the CPU; (c) the grid extras (the fusions,
                collapse_min, statistics, local-focus HM, 3D filters, Moran's
                I) on the headline fused and camera DSIs, the card against
                the CPU; (d) scripts/evaluate_dsec_torch.py on the CLI's
                fused depth maps against evaluate_sequence; (e) the
                golden probe's five specs on BENCH16 (scored, not gated);
                (f) the butterfly probe, the card against the CPU.
 12. programs -- the chunk's programs (`mapper.evaluate_dsi`'s CUDA graphs)
                against `mapper.eager()` on the headline chunk under the
                headline spec, every phase-6 spec form and `scatter`: each
                camera's DSI within phase 3's tolerance (i8 equal, sort
                within 1e-6 relative L1), vote mass within 1e-3, depth
                indices equal on >= 99.9 % of the pixels, a replay's launch
                counts equal to eager's, peak device memory of each; a
                returned DSI unchanged by the next replay; a chunk of
                refused int8 weights raises; eager and captured chunks timed
                in turns, one profiled chunk of each
                (scripts/profile_torch_chunk.py), capture seconds per
                program and the output copy's time.
 13. whole-chunk programs -- process_1 + get_depth_map, the extraction
                under every collapse, process_2's temporal step and events
                on the card, each on programs against `mapper.eager()`; the
                roofline and the stage profiler.
 14. bench   -- bench_torch.py in this process: each step's program (the
                voting step, the full chunk, alg2) equal to its body under
                `mapper.eager()` with kernels A and B launched in its
                replay; its stages as its main runs them (the timed region
                0.3 s, 22 sustained chunks, phase 13's roofline), its JSON
                line printed, no stage failed, kernels A and B launched in
                every stage, 20 chunks timed of 2 Mi events from the store,
                their PNGs, the golden gate passed on the literal spec; the
                sustained chunks' downlinked bytes equal to the same loop's
                inside `mapper.eager()`.
 15. scaling -- scripts/scaling_bench_torch.py's protocol at its workload
                (320x240x64, 262,144 events, `hist:g16,seg8`, packet 512):
                meshes (1,1), (2,1), (4,1), (8,1), (1,8), (2,4) on up to 8
                ranks sharing the card (gloo), each the min over 6 runs of
                3 steps; its table and report, each row's share of rank
                0's depth indices equal to the (1,1) row's (recorded, not
                gated); fails on a missing or non-finite row, on kernels
                A and B not both launched on the (1,1) row, or on report
                fields other than SCALING.json's plus `backend` and
                `ranks`.  Its launches of kernels A and B are added to
                their rows of the kernels line.
Phases 4-11 run the chunk on its programs, as a user's call does, and
phase 10 the sharded steps on theirs.
Each phase logs its seconds; the line before the two result lines gives
the total and each phase's share.
Phase 3 also holds kernels A and B against their plain versions past the
65,535 groups or items a launch of the earlier kernels took.  Each path's
launch counts are read from a run that starts with every count at zero.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
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
# The further spec forms of the kernel engine, each with the kernels it must
# reach: int8 binning, the flat merge, the non-segmented sweep, 2x
# supersampling, f32 histograms, no sweep correction with custom padding.
SPEC_FORMS = {
    "hist:g16,seg16,bf,i8,pl": ("bin_events", "banded_resample_sum", "banded_resample_fanin"),
    "hist:g16,seg16,pl": ("bin_events", "banded_resample_sum"),
    "hist:g16,pl": ("bin_events", "banded_resample_sum"),
    "hist:g16,ss2,seg16,bf,pl": ("bin_events", "banded_resample_sum", "banded_resample_fanin"),
    "hist:g16,seg16,bf,f32,pl": ("bin_events", "banded_resample_sum", "banded_resample_fanin"),
    "hist:g16,seg16,bf,nocorr,px96,py16,pl": ("bin_events", "banded_resample_sum",
                                              "banded_resample_fanin"),
    # The one-hot engine's specs (no "pl"), on the same kernels: the JAX
    # package's off-TPU auto spec for this chunk, its two named histogram
    # backends, and the sort + segment-sum form of the exact scatter.
    "hist:g16,ss2,seg10": ("bin_events", "banded_resample_sum"),
    "hist": ("bin_events", "banded_resample_sum"),
    "hist_exact": ("bin_events", "banded_resample_sum"),
    "sort": (),
}
I8_SPEC, FLAT_SPEC = "hist:g16,seg16,bf,i8,pl", "hist:g16,seg16,pl"
# A spec form's per-camera vote mass against the headline spec's.
SPEC_MASS_REL = 0.01
# The small chunk on the card against the CPU (the plain versions).
DEVICE_VS_CPU_SPECS = ("hist:g4,seg4,i8,pl", "hist:g4,ss2,pl", "hist:g4,ss2,seg5", "sort")
DEVICE_VS_CPU_L1, DEVICE_VS_CPU_MASS = 1e-2, 1e-3
# `sort` against the exact scatter on the headline chunk: the same votes
# summed in another order (float64 running sums in `sort`).
SORT_VS_SCATTER = 1e-3
# Histogram grid of the headline spec: (480 + 2*32) x (640 + 2*128), aligned
# to 64/128; the dense binning form's grid drops the alignment to 64 rows.
HS, WS = 576, 896
HS_DENSE = 552
# The platform probes' shapes (scripts/probe_tpu.py): one 576 x 896 block,
# an (8, 128) tile, a stream of 256 bf16 blocks.
PROBE_H, PROBE_W, PROBE_G = 576, 896, 256
N_TIMED = 10

# Kernel vs plain version: both round to bf16 at the same points and sum in
# f32 in different orders, so a sum may land one bf16 step (2^-8) away, at
# most twice on one path (y stage, output cast): |k - p| <= 2^-6 |p| plus
# 1e-4 of the largest value.  The int8 binning mode and the probes sum
# exactly or in a fixed order on both sides: tolerance 0.
RTOL, ATOL_OF_MAX = 2.0 ** -6, 1e-4

# Phase 3's cases past the 65,535 groups or items a launch of the earlier
# kernels took: binning G groups of E events into hs x ws (2.3 GB of f32 at
# these numbers), then G resample items of K of those planes each.
CAP_G, CAP_E, CAP_HS, CAP_WS, CAP_K = 70_000, 16, 64, 128, 2
# Phase 8: sub-intervals of process_2/5; the full_seq streams (events per
# camera) and their chunk length and stride as fractions of their time span;
# a pipeline's per-camera temporal AM mass (times the sub-interval count)
# against process_1's on the same events.
N_INTERVALS = 4
FULL_SEQ_EVENTS = 4 * N_EVENTS
FULL_SEQ_DURATION, FULL_SEQ_SKIP = 0.2, 0.1
TEMPORAL_MASS_REL = 0.01
# The multi-frame golden gate of tests/test_golden.py (the JAX package's
# production spec plus ~11 %): frames, median relative error, mean error
# (m), bad-p.
MULTIFRAME_GATE = {"frames": 5, "median_rel": 0.05, "mean_err": 1.9, "bad_p": 0.29}
KERNELS_A_B = ("bin_events", "banded_resample_sum", "banded_resample_fanin")
# Phase 9: MVSEC presets from a ROS1 bag of the synthetic rig at the DAVIS
# 346 x 260 (the bag's 2 s stand for the presets' 55 s of indoor_flying1:
# the one cut), 2 Mi events a camera; the fused depth's median distance to
# the scene's planes must stay below PLANE_DIST_M.  The focus collapses on
# the card against the CPU: confidence within COLLAPSE_RTOL of each value,
# depth indices equal on COLLAPSE_EQUAL of the pixels.  A chunk of
# DEEP_Z planes takes the extraction's sort-path median.
MVSEC_PRESETS = {
    "alg1": "configs/upenn_mvsec/flying1_full/alg1/flying1.conf",
    "AtHc": "configs/upenn_mvsec/flying1_full/AtHc/flying1.conf",
}
BAG_SECONDS, BAG_PTS, BAG_SAMPLES = 2.0, 20_000, 105
PRESET_MIN_CHUNKS = 10
PLANE_DIST_M = 0.2
COLLAPSE_RTOL, COLLAPSE_EQUAL = 1e-4, 0.999
DEEP_Z = 300

# Phase 10: the sharded step against process_1 on the headline chunk:
# fused-DSI relative L1, vote mass, share of pixels with equal depth indices
# (per plane block under plane shards); median of DIST_RUNS chunks after a
# warm-up; the meshes of two ranks sharing one device.  The CLI's two
# processes run the esim fixture cut to CLI_PACKETS packets of PACKET_CLI
# events a camera.
DIST_L1, DIST_MASS, DIST_EQUAL = 1e-3, 1e-3, 0.999
DIST_RUNS = 3
# Each mesh of two ranks with the kernels it must reach: under plane
# shards a z-block holds half the butterfly's segments, and a block with an
# empty segment sweeps segment by segment on the sum wrapper, not the fan-in.
DIST_MESHES = {(2, 1): KERNELS_A_B, (1, 2): ("bin_events", "banded_resample_sum")}
CLI_PACKETS, PACKET_CLI = 64, 1024

# A kernel's bound (the least time for its work on an H100 SXM) comes from
# the one work model, scripts/roofline_torch.py (`work_model()`).
# `cuda_graph_ms` captures as many calls as fill a third of this many seconds.
GRAPH_SECONDS = 0.15


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of `fn` over `iters` back-to-back Python
    calls between two CUDA events, after one warm-up call.  Where a call is
    shorter than the host's cost of making it, this times the host."""
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


@functools.lru_cache(maxsize=None)
def script(name: str):
    """scripts/<name>.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    # Registered under its name, so that ranks it spawns can import it.
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def cuda_graph_ms(fn) -> float:
    """Device milliseconds per call of `fn` alone, by scripts/probe_gpu.py's
    `cuda_graph_ms` (calls captured in one CUDA graph, best of three
    replays).  `fn` must not wait for the card (a host sync inside a capture
    raises).  A wrapper counts its launches when they are captured."""
    return script("probe_gpu").cuda_graph_ms(fn, GRAPH_SECONDS)


def timings(run, plain, library=None, *, iters: int, plain_iters: int = 2) -> dict:
    """A row's times: `ms` of `run` by `cuda_graph_ms` (`timer` "graph":
    every kernel's call now runs without a host sync), `loop_ms` of `run` and
    `plain_ms` of `plain` by `cuda_ms`, `library_ms` of `library` (a PyTorch
    call) by `cuda_graph_ms`."""
    return dict(ms=cuda_graph_ms(run), loop_ms=cuda_ms(run, iters),
                plain_ms=cuda_ms(plain, plain_iters),
                library_ms=None if library is None else cuda_graph_ms(library),
                timer="graph")


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


def compare_exact(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """0.0 when `got` equals `want` bit for bit in dtype and value; raises
    otherwise."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} != "
                             f"{want.dtype} {tuple(want.shape)}")
    max_abs = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    log(f"  {name}: max_abs_err {max_abs:.6g}; tolerance 0 -> "
        f"{'ok' if max_abs == 0 else 'FAIL'}")
    if max_abs != 0 or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel differs from its plain version")
    return max_abs


def work_model():
    """scripts/roofline_torch.py: the work model (bytes, operations, bound)
    that phase 3's kernel rows and the roofline's stages share."""
    return script("roofline_torch")


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


def resample_edge_cases(dev, hist, rng, iters) -> float:
    """Kernel B at the edges of its two paths, through banded_resample_sum
    against its plain version; logs each case's time.  Returns the largest
    error.  The cases: maps at scale ~0.3, whose tile bands are wider than
    the staging buffer, so every tile runs the per-pixel loop; translations
    that put part of each band off the source, with the last source of every
    item at scale ~0.3, so that blocks mix both paths; an output height and
    width that are not multiples of the 16 x 128 tile, from f32 sources, 70
    a plane (more than the kernel holds tile boxes for at once)."""
    from dvs_mcemvs_torch.kernels import resample

    f32 = dict(dtype=torch.float32, device=dev)

    def case(label, h, scale, t_y, t_x, out_h, out_w, out_dtype):
        J, K = scale.shape
        src = rng.integers(0, h.shape[0], (J, K)).astype(np.int32)
        sy = torch.as_tensor(scale + rng.uniform(-5e-3, 5e-3, (J, K)), **f32)
        sx = torch.as_tensor(scale + rng.uniform(-5e-3, 5e-3, (J, K)), **f32)
        ty, tx = torch.as_tensor(t_y, **f32), torch.as_tensor(t_x, **f32)

        def run():
            return resample.banded_resample_sum(h, sy, ty, sx, tx, out_h=out_h, out_w=out_w,
                                                blocked=True, src=src, out_dtype=out_dtype)

        want = resample.banded_resample_reference(
            h, torch.as_tensor(src, dtype=torch.long, device=dev), sy, ty, sx, tx,
            torch.arange(J, device=dev), n_out=J, out_h=out_h, out_w=out_w, out_dtype=out_dtype)
        what = (f"{label} ({J}x{K}, {h.shape[1]}x{h.shape[2]} {str(h.dtype).split('.')[-1]} -> "
                f"{out_h}x{out_w} {str(out_dtype).split('.')[-1]})")
        err = compare(f"banded_resample_sum {what}", run(), want)
        log(f"  banded_resample_sum {what}: {cuda_ms(run, iters):.4f} ms")
        return err

    def signed(lo, hi, shape):
        return rng.choice([-1.0, 1.0], shape) * rng.uniform(lo, hi, shape)

    _, hs, ws = hist.shape
    scale_off = np.ones((64, 4))
    scale_off[:, -1] = 0.3
    return max(
        case("wide band, scale 0.3", hist, np.full((16, 4), 0.3), rng.uniform(-1, 1, (16, 4)),
             rng.uniform(-1, 1, (16, 4)), 160, 256, torch.bfloat16),
        case("bands off the source edge", hist, scale_off, signed(0.15 * hs, 0.45 * hs, (64, 4)),
             signed(0.2 * ws, 0.55 * ws, (64, 4)), hs, ws, torch.bfloat16),
        case("ragged output", hist.float(), np.ones((20, 70)), rng.uniform(-3, 3, (20, 70)),
             rng.uniform(-3, 3, (20, 70)), 470, 630, torch.float32))


def log_binning_plan(dev, what, hs, ws, E, int8, out_dtype):
    """Log kernel A's launch plan for one case and how many of its clusters
    the card holds at once (cudaOccupancyMaxActiveClusters)."""
    from dvs_mcemvs_torch.kernels import binning

    p = binning.plan(hs, ws, E, int8)
    occupancy = (binning.max_active_clusters(p, out_dtype == torch.bfloat16)
                 if dev.type == "cuda" else "not measured")
    log(f"  bin_events plan {what} ({hs}x{ws}, E={E}): {p.acc} sums, C={p.cluster}, "
        f"R={p.rows}, {p.bands} bands, {p.smem_bytes} bytes of shared memory a block; "
        f"max active clusters {occupancy}")


def binning_edge_cases(dev, G, E, hs, ws, iters) -> dict:
    """Kernel A beyond phase 3's four binning rows, each against its plain
    version (int8: bit for bit); logs each case's time.  The cases: the ss2
    grid (2 hs x 2 ws, several bands a group); events on every block and
    band edge of the headline grid's plan (rows lo - 1, lo - 0.5, lo) and on
    its last row, under the plan and under clusters of 8 blocks (adds into
    the other blocks' shared memory); the 64-bit int8 sums (2 groups of
    300,000 events, 280,000 of them on one bin, whose sum passes 2^32); a
    ragged 552 x 830 grid (rows and output spans off the 16-byte
    boundaries).  Returns the largest error of the f32-tap cases and of the
    int8 ones, {False: e, True: e}."""
    from dvs_mcemvs_torch.kernels import binning

    rng = np.random.default_rng(5)
    f32 = dict(dtype=torch.float32, device=dev)
    errs = {False: 0.0, True: 0.0}

    def events(G_, E_, h, w_cols):
        hx = rng.uniform(0, w_cols - 1, (G_, E_))
        hy = np.sort(rng.normal(h / 2, h / 5, (G_, E_)).clip(0, h - 1))
        w = rng.uniform(0, 1, (G_, E_)) * (rng.uniform(size=(G_, E_)) > 0.1)
        return hx, hy, w

    def case(label, hx, hy, w, h, w_cols, int8, out_dtype, cluster=binning.CLUSTER):
        hx, hy, w = (torch.as_tensor(a, **f32) for a in (hx, hy, w))
        G_, E_ = hx.shape
        p = binning.plan(h, w_cols, E_, int8, cluster=cluster)

        def run():
            if dev.type == "cuda" and cluster != binning.CLUSTER:
                return binning.launch(hx, hy, w, p, out_dtype)
            return binning.bin_events(hx, hy, w, hs=h, ws=w_cols, int8=int8,
                                      out_dtype=out_dtype)

        plain = binning.bin_events_int8_reference if int8 else binning.bin_events_reference
        want = plain(hx, hy, w, h, w_cols).to(out_dtype)
        what = (f"{label} ({G_}x{E_} -> {G_}x{h}x{w_cols} {str(out_dtype).split('.')[-1]}; "
                f"{p.acc} sums, C={p.cluster}, R={p.rows}, {p.bands} bands)")
        err = (compare_exact if int8 else compare)(f"bin_events {what}", run(), want)
        errs[int8] = max(errs[int8], err)
        log(f"  bin_events {label}: {cuda_ms(run, iters):.4f} ms")

    ss2 = events(G, E, 2 * hs, 2 * ws)
    case("ss2", *ss2, 2 * hs, 2 * ws, False, torch.float32)
    case("ss2 int8", *ss2, 2 * hs, 2 * ws, True, torch.bfloat16)

    hx, hy, w = events(G, E, hs, ws)
    on_edge = rng.uniform(size=(G, E)) < 0.5
    for cluster in (binning.CLUSTER, 8):
        lows = [lo for lo, _ in binning.plan(hs, ws, E, False, cluster=cluster).block_rows()
                if 0 < lo < hs]
        edge_rows = np.array([y for lo in lows for y in (lo - 1, lo - 0.5, lo)] + [hs - 1])
        hy = np.where(on_edge, rng.choice(edge_rows, (G, E)), hy)
        tag = "" if cluster == binning.CLUSTER else f", C={cluster}"
        case(f"band edges{tag}", hx, hy, w, hs, ws, False, torch.bfloat16, cluster)
        case(f"band edges int8{tag}", hx, hy, w, hs, ws, True, torch.bfloat16, cluster)

    hx, hy, w = events(2, 300_000, hs, ws)
    hx[:, :280_000], hy[:, :280_000], w[:, :280_000] = ws // 2, hs // 2, 1.0
    case("int8 u64", hx, hy, w, hs, ws, True, torch.float32)

    ragged = events(G, E, 552, 830)
    case("ragged", *ragged, 552, 830, False, torch.bfloat16)
    case("ragged int8", *ragged, 552, 830, True, torch.float32)
    return errs


def cap_cases(dev, G, E, hs, ws, K, iters) -> tuple:
    """Kernels A and B past 65,535 groups or items a launch: bin G groups of
    E events into (G, hs, ws) float32, then G resample items of K of those
    planes (bf16) each into a bf16 plane, each against its plain version on
    the same inputs.  Returns (binning error, resample error)."""
    from dvs_mcemvs_torch.kernels import binning, resample

    gen = torch.Generator(device=dev).manual_seed(65536)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    hx, hy = rand(G, E) * (ws - 1), rand(G, E) * (hs - 1)
    w = rand(G, E) * (rand(G, E) > 0.1)

    def run_a():
        return binning.bin_events(hx, hy, w, hs=hs, ws=ws)

    got = run_a()
    err_a = compare(f"bin_events past the cap ({G}x{E} -> {G}x{hs}x{ws} float32, "
                    f"{binning.plan(hs, ws, E, False)})", got,
                    binning.bin_events_reference(hx, hy, w, hs, ws))
    log(f"  bin_events past the cap: {cuda_ms(run_a, iters):.4f} ms")
    src = got.to(torch.bfloat16)
    del got
    rng = np.random.default_rng(65536)
    src_idx = rng.integers(0, G, (G, K)).astype(np.int32)
    f32 = dict(dtype=torch.float32, device=dev)
    sy = torch.as_tensor(1.0 + rng.uniform(-2e-3, 2e-3, (G, K)), **f32)
    ty = torch.as_tensor(rng.uniform(-1.5, 1.5, (G, K)), **f32)
    tx = torch.as_tensor(rng.uniform(-3.0, 3.0, (G, K)), **f32)

    def run_b():
        return resample.banded_resample_sum(src, sy, ty, sy, tx, out_h=hs, out_w=ws,
                                            blocked=True, src=src_idx,
                                            out_dtype=torch.bfloat16)

    err_b = compare(f"banded_resample_sum past the cap ({G}x{K}, {hs}x{ws} bf16)", run_b(),
                    resample.banded_resample_reference(
                        src, torch.as_tensor(src_idx, dtype=torch.long, device=dev), sy, ty,
                        sy, tx, torch.arange(G, device=dev), n_out=G, out_h=hs, out_w=ws,
                        out_dtype=torch.bfloat16))
    log(f"  banded_resample_sum past the cap: {cuda_ms(run_b, iters):.4f} ms")
    return err_a, err_b


def one_hot_engine_cases(dev, G, E, Z, Ho, Wo, iters, small=(260, 346)) -> dict:
    """Kernels A and B in the call forms the one-hot engine's specs give
    them for Z planes of Ho x Wo (the headline rig: 100 of 480 x 640), each
    against its plain version: binning on the unaligned (Ho + 64) x (Wo +
    256) grid of ss1 (the dense form; f32 taps and int8) and on the grid of
    ss2 (1088 x 1792); kernel B's non-segmented sweep from those 544-row
    sources into Ho x Wo, the ss2 flat merge (7 supergroups of 10 leaves) on
    the merge maps of leaves spread over the chunk's 0.5 m of travel, and a
    sweep of G/2 groups into `small` planes (MVSEC's 260 x 346: an output
    width that is not a multiple of 128).  Returns the
    largest error of each kernel row, {"bin_events", "bin_events_int8",
    "bin_events_dense", "banded_resample_sum"}."""
    from dvs_mcemvs_torch.kernels import binning, resample
    from dvs_mcemvs_torch.ops import voting_hist as vh

    rng = np.random.default_rng(7)
    f32 = dict(dtype=torch.float32, device=dev)
    hs1, ws1 = Ho + 2 * vh.PAD_Y, Wo + 2 * vh.PAD_X
    errs = {"bin_events": 0.0, "bin_events_int8": 0.0, "bin_events_dense": 0.0,
            "banded_resample_sum": 0.0}

    def binning_case(label, row, h, w_cols, int8):
        hx = torch.as_tensor(rng.uniform(0, w_cols - 1, (G, E)), **f32)
        hy = torch.as_tensor(np.sort(rng.normal(h / 2, h / 5, (G, E)).clip(0, h - 1)), **f32)
        w = torch.as_tensor(rng.uniform(size=(G, E)) > 0.1, **f32)

        def run():
            return binning.bin_events(hx, hy, w, hs=h, ws=w_cols, binary_w=True, int8=int8,
                                      out_dtype=torch.bfloat16)

        plain = binning.bin_events_int8_reference if int8 else binning.bin_events_reference
        what = f"bin_events one-hot {label} ({G}x{E} -> {G}x{h}x{w_cols} bfloat16)"
        err = (compare_exact if int8 else compare)(what, run(),
                                                   plain(hx, hy, w, h, w_cols).to(torch.bfloat16))
        errs[row] = max(errs[row], err)
        log(f"  {what}: {cuda_ms(run, iters):.4f} ms")

    binning_case("ss1, unaligned rows", "bin_events_dense", hs1, ws1, False)
    binning_case("ss1, unaligned rows, int8", "bin_events_dense", hs1, ws1, True)
    binning_case("ss2", "bin_events", 2 * hs1, 2 * ws1, False)

    def resample_case(label, hist, maps, src, out_h, out_w, blocked, out_dtype):
        N, K = maps[0].shape

        def run():
            return resample.banded_resample_sum(hist, *maps, out_h=out_h, out_w=out_w,
                                                blocked=blocked, src=src, out_dtype=out_dtype)

        want = resample.banded_resample_reference(
            hist, torch.as_tensor(src, dtype=torch.long, device=dev), *maps,
            torch.arange(N, device=dev), n_out=N, out_h=out_h, out_w=out_w, out_dtype=out_dtype)
        what = (f"banded_resample_sum one-hot {label} ({N}x{K}, {hist.shape[1]}x{hist.shape[2]} "
                f"-> {out_h}x{out_w} {str(out_dtype).split('.')[-1]})")
        errs["banded_resample_sum"] = max(errs["banded_resample_sum"],
                                          compare(what, run(), want))
        log(f"  {what}: {cuda_ms(run, iters):.4f} ms")

    def sweep(label, K, h, w_cols, out_h, out_w):
        blocks, sy, ty, sx, tx, _ = _sweep_inputs(dev, 1, K, Z, h, w_cols, rng)
        maps = [m.reshape(Z, K) for m in (sy, ty, sx, tx)]
        src = np.tile(np.arange(K)[None, :], (Z, 1))
        resample_case(label, blocks[0].contiguous(), maps, src, out_h, out_w, False,
                      torch.float32)

    sweep(f"sweep, {hs1}-row sources", G, hs1, ws1, Ho, Wo)
    sweep(f"sweep into {small[0]} x {small[1]}", G // 2, small[0] + 2 * vh.PAD_Y,
          small[1] + 2 * vh.PAD_X, *small)

    # The ss2 flat merge: leaves along the chunk's travel, merged 10 to a
    # supergroup at the first segment's inverse-depth midpoint.
    P, merge = 7, 10
    centers = torch.zeros((P * merge, 3), **f32)
    centers[:, 0] = torch.linspace(0.0, 0.5, P * merge, device=dev)
    sup = torch.repeat_interleave(centers.reshape(P, merge, 3).mean(1), merge, dim=0)
    u = 1.0 / np.linspace(2.0, 40.0, Z)[:max(1, Z // 10)]
    m_s, bt_y, bt_x = vh._frame_change_maps(centers, sup, float(0.5 * (u.min() + u.max())),
                                            2.0, (Wo * 0.9, Wo * 0.9, Wo / 2, Ho / 2),
                                            vh.PAD_X, vh.PAD_Y, 2)
    hist = torch.as_tensor(rng.gamma(0.3, 2.0, (P * merge, 2 * hs1, 2 * ws1)),
                           **f32).to(torch.bfloat16)
    s_ = m_s.reshape(P, merge).contiguous()
    src = np.arange(P * merge).reshape(P, merge)
    resample_case("ss2 flat merge", hist, [s_, bt_y.reshape(P, merge).contiguous(), s_,
                                          bt_x.reshape(P, merge).contiguous()],
                  src, 2 * hs1, 2 * ws1, True, torch.bfloat16)
    return errs


def wrappers() -> dict:
    """Every kernel wrapper of the port by name; each counts its launches."""
    from dvs_mcemvs_torch.kernels import binning, probes, resample

    return {"bin_events": binning.bin_events,
            "banded_resample_sum": resample.banded_resample_sum,
            "banded_resample_fanin": resample.banded_resample_fanin,
            "smem_copy": probes.smem_copy, "block_step": probes.block_step,
            "hbm_stream": probes.hbm_stream, "dyn_slice": probes.dyn_slice}


def zero_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def empty_calls_launch_nothing(dev):
    """Calls with no events or no items launch no kernel, so their wrappers
    count no launch."""
    from dvs_mcemvs_torch.kernels import binning, probes, resample

    before = read_counts()
    f32 = dict(dtype=torch.float32, device=dev)
    none = torch.zeros((2, 0), **f32)
    hist = binning.bin_events(none, none, none, hs=64, ws=128, out_dtype=torch.bfloat16)
    binning.bin_events(none, none, none, hs=64, ws=128, int8=True)
    maps = torch.zeros((0, 2), **f32)
    resample.banded_resample_sum(hist, maps, maps, maps, maps, out_h=48, out_w=64,
                                 blocked=False)
    resample.banded_resample_fanin(hist[None], *[maps[None]] * 4, np.zeros((1, 0), int),
                                   n_out=3, out_h=48, out_w=64)
    empty = torch.zeros((1, 0, 8), **f32)
    probes.smem_copy(empty)
    probes.block_step(empty)
    probes.hbm_stream(torch.zeros((2, 0, 8), dtype=torch.bfloat16, device=dev))
    probes.dyn_slice(torch.zeros((1, 200, 0), **f32))
    if read_counts() != before:
        raise AssertionError("an empty call counted a kernel launch")
    log("  empty calls: no launch counted")


def kernel_phase(dev, G=64, E=16384, hs=HS, ws=WS, hs_dense=HS_DENSE, Ho=HEIGHT,
                 Wo=WIDTH, Z=DIM_Z, S=16, K_sweep=4, K_wide=32, probe_h=PROBE_H,
                 probe_w=PROBE_W, probe_g=PROBE_G, iters=10,
                 cap=(CAP_G, CAP_E, CAP_HS, CAP_WS, CAP_K), **one_hot_small):
    """Each kernel against its plain version on `dev` at the given shapes,
    kernels A and B past the old cap at `cap` = (G, E, hs, ws, K), and in the
    one-hot engine's call forms for Z planes of Ho x Wo (`one_hot_small`:
    `one_hot_engine_cases`' `small`).
    Returns {kernel name: {max_abs_err, ms, loop_ms, timer, plain_ms,
    library_ms, bound_ms, bound_by, ceiling_ms, ceiling_share}}; the on-chip
    ceiling is None but for the shared-memory probes on a card."""
    from dvs_mcemvs_torch.kernels import _build, binning, probes, resample

    wm = work_model()
    rng = np.random.default_rng(0)
    results = {}
    f32 = dict(dtype=torch.float32, device=dev)
    empty_calls_launch_nothing(dev)

    # Kernel A: binning, weighted (the padded main path) and 0/1 weights;
    # f32 taps and the int8 mode; the row-windowed grid and the dense one.
    def events(h):
        hx = torch.as_tensor(rng.uniform(0, ws - 1, (G, E)), **f32)
        hy = torch.as_tensor(np.sort(rng.normal(h / 2, h / 5, (G, E)).clip(0, h - 1)), **f32)
        return hx, hy

    weights = {"weighted": rng.uniform(0, 1, (G, E)) * (rng.uniform(size=(G, E)) > 0.1),
               "binary": (rng.uniform(size=(G, E)) > 0.1).astype(np.float64)}

    def binning_row(h, int8, out_dtype, what):
        hx, hy = events(h)
        plain_fn = binning.bin_events_int8_reference if int8 else binning.bin_events_reference
        log_binning_plan(dev, what, h, ws, E, int8, out_dtype)
        errs = []
        for label, w_np in weights.items():
            w = torch.as_tensor(w_np, **f32)
            got = binning.bin_events(hx, hy, w, hs=h, ws=ws, binary_w=label == "binary",
                                     int8=int8, out_dtype=out_dtype)
            want = plain_fn(hx, hy, w, h, ws).to(out_dtype)
            name = (f"bin_events {what} {label} ({G}x{E} -> {G}x{h}x{ws} "
                    f"{str(out_dtype).split('.')[-1]})")
            errs.append(compare_exact(name, got, want) if int8 else compare(name, got, want))
        w = torch.as_tensor(weights["weighted"], **f32)
        live = int((w != 0).sum())

        # The int8 mode's weight check sets a device flag, as in a program,
        # instead of reading the device: the call can be graph-timed.
        def run():
            with binning.deferred_weight_checks(flag):
                return binning.bin_events(hx, hy, w, hs=h, ws=ws, int8=int8,
                                          out_dtype=out_dtype)

        row = dict(
            max_abs_err=max(errs),
            **timings(run, lambda: plain_fn(hx, hy, w, h, ws).to(out_dtype), iters=iters,
                      plain_iters=iters),
            **wm.bound(*wm.binning_work(G, E, h, ws, torch.finfo(out_dtype).bits // 8, live)))
        binning.raise_weight_faults(flag)
        return row

    flag = binning.fault_flag(dev)
    results["bin_events"] = binning_row(hs, False, torch.bfloat16, "windowed")
    results["bin_events_int8"] = binning_row(hs, True, torch.bfloat16, "int8 windowed")
    dense = binning_row(hs_dense, False, torch.float32, "dense")
    dense_i8 = binning_row(hs_dense, True, torch.float32, "int8 dense")
    results["bin_events_dense"] = dict(dense, max_abs_err=max(dense["max_abs_err"],
                                                              dense_i8["max_abs_err"]))
    log(f"  bin_events int8 dense: kernel {dense_i8['ms']:.4f} ms, "
        f"plain {dense_i8['plain_ms']:.4f} ms")
    w_check = torch.as_tensor(weights["weighted"], **f32)

    def deferred_check():
        with binning.deferred_weight_checks(flag):
            binning._check_weights(w_check, False, True)

    log(f"  bin_events int8 weight check alone: on the device into the fault flag (inside "
        f"the int8 rows' times) {cuda_graph_ms(deferred_check):.4f} ms by graph; with its "
        f"read to the host (calls outside a program) "
        f"{cuda_ms(lambda: binning._check_weights(w_check, False, True), iters):.4f} ms")
    binning.raise_weight_faults(flag)
    report = _build.BUILD_INFO.get("binning", (0.0, ""))[1]
    for line in report.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(f"  binning ptxas: {line.strip()}")
    edge_errs = binning_edge_cases(dev, G, E, hs, ws, iters)
    results["bin_events"]["max_abs_err"] = max(results["bin_events"]["max_abs_err"],
                                               edge_errs[False])
    results["bin_events_int8"]["max_abs_err"] = max(results["bin_events_int8"]["max_abs_err"],
                                                    edge_errs[True])
    cap_err_a, cap_err_b = cap_cases(dev, *cap, iters=2)
    results["bin_events"]["max_abs_err"] = max(results["bin_events"]["max_abs_err"], cap_err_a)
    one_hot = one_hot_engine_cases(dev, G, E, Z, Ho, Wo, iters, **one_hot_small)
    for row in ("bin_events", "bin_events_int8", "bin_events_dense"):
        results[row]["max_abs_err"] = max(results[row]["max_abs_err"], one_hot.get(row, 0.0))

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

    out = merge()
    err = compare(f"banded_resample_sum merge ({src.shape[0]}x{src.shape[1]}, "
                  f"{hs}x{ws} bf16)", out, merge_plain())

    # The same wrapper's two other call forms: the flat merge (blocked, the
    # sources of item n are n*K..n*K+K-1) and the non-segmented sweep
    # (blocked=False, every group for every plane).
    K_flat = min(16, G)
    N_flat = G // K_flat
    flat_maps = [m.reshape(-1)[:N_flat * K_flat].reshape(N_flat, K_flat).contiguous()
                 for m in (sy, ty, tx)]
    items_flat = torch.arange(N_flat, device=dev)
    src_flat = torch.arange(G, device=dev).reshape(N_flat, K_flat)

    def flat():
        return resample.banded_resample_sum(
            hist, flat_maps[0], flat_maps[1], flat_maps[0], flat_maps[2], out_h=hs, out_w=ws,
            blocked=True, out_dtype=torch.bfloat16)

    err_flat = compare(f"banded_resample_sum flat merge ({N_flat}x{K_flat}, {hs}x{ws} bf16)",
                       flat(), resample.banded_resample_reference(
                           hist, src_flat, flat_maps[0], flat_maps[1], flat_maps[0],
                           flat_maps[2], items_flat, n_out=N_flat, out_h=hs, out_w=ws,
                           out_dtype=torch.bfloat16))
    _, s_sy, s_ty, s_sx, s_tx, _ = _sweep_inputs(dev, 1, G, Z, hs, ws, rng)
    sweep_maps = [m.reshape(Z, G) for m in (s_sy, s_ty, s_sx, s_tx)]

    def sweep_form():
        return resample.banded_resample_sum(hist, *sweep_maps, out_h=Ho, out_w=Wo,
                                            blocked=False)

    err_sweep = compare(
        f"banded_resample_sum sweep ({Z}x{G} -> {Z}x{Ho}x{Wo})", sweep_form(),
        resample.banded_resample_reference(
            hist, torch.arange(G, device=dev).expand(Z, G), *sweep_maps,
            torch.arange(Z, device=dev), n_out=Z, out_h=Ho, out_w=Wo))
    log(f"  banded_resample_sum flat merge: {cuda_ms(flat, iters):.4f} ms; sweep form: "
        f"{cuda_ms(sweep_form, 2):.4f} ms")
    err = max(err, err_flat, err_sweep, cap_err_b, resample_edge_cases(dev, hist, rng, iters),
              one_hot.get("banded_resample_sum", 0.0))
    # Kernel B's index tables are device tables fetched from a cache (no
    # copy, no sync), so its rows are graph-timed.
    results["banded_resample_sum"] = dict(
        max_abs_err=err, **timings(merge, merge_plain, iters=iters),
        **wm.bound(*wm.resample_sum_work(G, hs, ws, hist.element_size(), *src.shape, hs, ws,
                                         out.element_size())))

    # Kernel B through banded_resample_fanin: the plane sweep, and K = 32.
    def fanin_case(label, S_, K_, Z_, n_plain):
        blocks, sy_, ty_, sx_, tx_, out_idx = _sweep_inputs(dev, S_, K_, Z_, hs, ws, rng)

        def run():
            return resample.banded_resample_fanin(blocks, sy_, ty_, sx_, tx_, out_idx,
                                                  n_out=Z_, out_h=Ho, out_w=Wo)

        # The plain version on the same items (one per plane, its last writer).
        sources, src_idx, maps, items_out = resample.fanin_items(
            blocks, sy_, ty_, sx_, tx_, out_idx, n_out=Z_)
        src_idx_t = src_idx.long()
        items_t = items_out.long()

        def plain():
            return resample.banded_resample_reference(
                sources, src_idx_t, *maps, items_t, n_out=Z_, out_h=Ho, out_w=Wo)

        got = run()
        err_ = compare(f"banded_resample_fanin {label} ({S_}x{out_idx.shape[1]}x{K_} -> "
                       f"{Z_}x{Ho}x{Wo}, duplicates in out_idx)", got, plain())
        work = wm.resample_fanin_work(S_, K_, hs, ws, blocks.element_size(), out_idx.shape[1],
                                      len(items_out), Z_, Ho, Wo)
        return dict(max_abs_err=err_,
                    **timings(run, plain, iters=iters, plain_iters=n_plain),
                    **wm.bound(*work))

    sweep = fanin_case("sweep", S, K_sweep, Z, 2)
    wide = fanin_case(f"K={K_wide}", 2, K_wide, 8, 1)
    log(f"  banded_resample_fanin K={K_wide}: {wide['ms']:.4f} ms, plain "
        f"{wide['plain_ms']:.4f} ms")
    results["banded_resample_fanin"] = dict(sweep, max_abs_err=max(sweep["max_abs_err"],
                                                                   wide["max_abs_err"]))

    # The platform probes at the TPU probes' shapes; each is exact.
    a32 = torch.as_tensor(rng.uniform(-2, 2, (1, probe_h, probe_w)), **f32)
    tile = torch.as_tensor(rng.uniform(-2, 2, (1, 8, 128)), **f32)
    stream = torch.as_tensor(rng.uniform(-4, 4, (probe_g, probe_h, probe_w)), **f32
                             ).to(torch.bfloat16)
    q_rows = {q + r for q in probes.offsets(probe_h) for r in range(probes.QV)}
    cases = {
        "smem_copy": (lambda: probes.smem_copy(a32), lambda: probes.smem_copy_reference(a32),
                      None, 2 * wm.nbytes(a32), 2 * a32.numel()),
        "block_step": (lambda: probes.block_step(tile),
                       lambda: probes.block_step_reference(tile),
                       lambda: torch.add(tile, 1.0), 2 * wm.nbytes(tile), tile.numel()),
        "hbm_stream": (lambda: probes.hbm_stream(stream),
                       lambda: probes.hbm_stream_reference(stream),
                       lambda: torch.sum(stream, 0, keepdim=True, dtype=torch.float32),
                       wm.nbytes(stream) + 4 * stream[0].numel(), stream.numel()),
        # rows of `a` the offsets reach, read once; the whole output written
        "dyn_slice": (lambda: probes.dyn_slice(a32), lambda: probes.dyn_slice_reference(a32),
                      None, 4 * probe_w * len(q_rows) + wm.nbytes(a32),
                      probes.STEPS * probes.N_OFFSETS * probes.QV * probe_w),
    }
    for name, (run, plain, library, moved, ops) in cases.items():
        err = compare_exact(f"{name} probe", run(), plain())
        results[name] = dict(max_abs_err=err, **timings(run, plain, library, iters=iters),
                             **wm.bound(moved, ops))
    # The shared-memory probes' on-chip ceiling: the bytes each is defined to
    # move through shared memory at the card's top SM clock.
    for r in results.values():
        r.update(ceiling_ms=None, ceiling_share=None)
    if dev.type == "cuda":
        gpu = script("probe_gpu")
        onchip = {"smem_copy": gpu.smem_copy_bytes(a32.numel(), probes.PASSES, probes.REPS),
                  "dyn_slice": gpu.dyn_slice_bytes(probe_w, probes.QV, probes.N_OFFSETS,
                                                   probes.STEPS)}
        now, top = gpu.sm_clocks_mhz()
        n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        log(f"  SM clock {now:.0f} MHz after the probes' timing, top {top:.0f} MHz; "
            f"{n_sms} SMs")
        for name, onchip_bytes in onchip.items():
            ceiling = gpu.ceiling_ms(onchip_bytes, n_sms, top)
            results[name].update(ceiling_ms=ceiling,
                                 ceiling_share=ceiling / results[name]["ms"])
    results["hbm_stream"]["max_abs_err"] = max(
        results["hbm_stream"]["max_abs_err"], hbm_stream_cases(dev, stream, rng))
    results["block_step"]["max_abs_err"] = max(
        results["block_step"]["max_abs_err"], block_step_cases(tile))
    results["smem_copy"]["max_abs_err"] = max(
        results["smem_copy"]["max_abs_err"], smem_copy_cases(dev, rng))
    results["dyn_slice"]["max_abs_err"] = max(
        results["dyn_slice"]["max_abs_err"], dyn_slice_cases(dev, rng))
    del stream
    for name, r in results.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        ceiling = ("" if r["ceiling_ms"] is None else
                   f", on-chip ceiling {r['ceiling_ms']:.4f} ms ({r['ceiling_share']:.1%})")
        log(f"  {name}: kernel {r['ms']:.4f} ms by {r['timer']} (loop {r['loop_ms']:.4f} "
            f"ms), plain {r['plain_ms']:.4f} ms, library {lib}, bound {r['bound_ms']:.4f} "
            f"ms by {r['bound_by']}{ceiling}")
    log(f"  (graph: device alone, calls in one CUDA graph, best of 3 replays; loop: "
        f"{iters} Python calls between CUDA events, the earlier measure; plain: loop)")
    return results


def hbm_stream_cases(dev, stream, rng) -> float:
    """hbm_stream against its plain version on ragged streams: fewer blocks
    than the ring's stages (2 and 3), a vector count that is no multiple of
    the SM count, slices longer than a tile.  Logs the probe's slice plan.
    Returns the largest error (0)."""
    from dvs_mcemvs_torch.kernels import probes

    shapes = ((2, *stream.shape[1:]), (3, 40, 136), (5, 40, 136), (3, 1100, 1000))
    errs = [compare_exact(f"hbm_stream {shape}", probes.hbm_stream(x),
                          probes.hbm_stream_reference(x))
            for shape in shapes
            for x in [torch.as_tensor(rng.uniform(-4, 4, shape), dtype=torch.float32,
                                      device=dev).to(torch.bfloat16)]]
    if dev.type == "cuda":
        n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        n8 = stream[0].numel() // 8
        lengths = [n for _, n in probes.stream_plan(n8, n_sms)]
        log(f"  hbm_stream plan: {n8} vectors on {n_sms} SMs, {len(lengths)} slices of "
            f"{min(lengths)}-{max(lengths)} vectors ({16 * max(lengths)} B a row)")
    return max(errs)


# smem_copy's ragged shapes (floats): one vector, fewer vectors than SMs,
# slices shorter than a warp (20 vectors an SM), slices past 1,024 vectors.
SMEM_COPY_SHAPES = ((4,), (4 * 100,), (4 * 132 * 20,), (1, 1100, 1000))
# dyn_slice's ragged shapes, as tests/test_torch_probes.py: H, W (no multiple
# of a strip; 901 and 3 no multiple of 4), qv, offsets; one step.  The last
# two stage more than 48 KB a block (93 and 219 KB), which takes the
# launcher's opt-in.
DYN_SLICE_SHAPES = tuple((h, w, qv, n) for h in (200, 1100) for w in (136, 900)
                         for qv in (8, h - 1) for n in (1, 20)) + (
                             (200, 901, 8, 20), (200, 3, 150, 20), (3000, 64, 40, 300),
                             (14_000, 4, 8, 512))


def smem_copy_cases(dev, rng) -> float:
    """smem_copy against its plain version at SMEM_COPY_SHAPES.  Logs the
    probe's slice plan.  Returns the largest error (0)."""
    from dvs_mcemvs_torch.kernels import probes

    errs = [compare_exact(f"smem_copy {shape}", probes.smem_copy(x),
                          probes.smem_copy_reference(x))
            for shape in SMEM_COPY_SHAPES
            for x in [torch.as_tensor(rng.uniform(-2, 2, shape), dtype=torch.float32,
                                      device=dev)]]
    if dev.type == "cuda":
        n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        n4 = PROBE_H * PROBE_W // 4
        lengths = [n for _, n in probes.stream_plan(n4, n_sms)]
        log(f"  smem_copy plan: {n4} vectors on {n_sms} SMs, {len(lengths)} slices of "
            f"{min(lengths)}-{max(lengths)} vectors, one a thread")
    return max(errs)


def dyn_slice_cases(dev, rng) -> float:
    """dyn_slice against its plain version at DYN_SLICE_SHAPES.  Logs the
    probe's plan.  Returns the largest error (0)."""
    from dvs_mcemvs_torch.kernels import probes

    errs = [compare_exact(f"dyn_slice H={h} W={w} qv={qv} {n} offsets",
                          probes.dyn_slice(x, qv, n, 1), probes.dyn_slice_reference(x, qv, n, 1))
            for h, w, qv, n in DYN_SLICE_SHAPES
            for x in [torch.as_tensor(rng.uniform(-2, 2, (1, h, w)), dtype=torch.float32,
                                      device=dev)]]
    if dev.type == "cuda":
        n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = probes.dyn_slice_plan(PROBE_H, PROBE_W, probes.QV, probes.offsets(PROBE_H),
                                     n_sms)
        log(f"  dyn_slice plan: {plan.n_items} items of {plan.strip} float4 x {plan.band} "
            f"rows on {len(plan.starts) - 1} blocks, {plan.batch} staged at once "
            f"({plan.smem_bytes} B, {plan.threads} threads)")
        for h, w, qv, n in DYN_SLICE_SHAPES[-2:]:
            big = probes.dyn_slice_plan(h, w, qv, probes.offsets(h, qv, n), n_sms)
            log(f"  dyn_slice H={h} W={w} qv={qv} {n} offsets: {big.smem_bytes} B a block")
    return max(errs)


def block_step_cases(tile) -> float:
    """block_step against its plain version at 1, 300 and 4,096 blocks
    (phase 7 times it at 1, 4,096 and 65,536).  Returns the largest error
    (0)."""
    from dvs_mcemvs_torch.kernels import probes

    return max(compare_exact(f"block_step {n} blocks", probes.block_step(tile, n),
                             probes.block_step_reference(tile)) for n in (1, 300, 4096))


# ---------------------------------------------------------------------------
# Phase 4: the two-camera chunk at the headline size
# ---------------------------------------------------------------------------


def build_workload(dev, n_events=N_EVENTS, width=WIDTH, height=HEIGHT, dim_z=DIM_Z,
                   n_pts=40_000):
    """The headline workload: bench.py:build_workload's rig, mapper, scene
    and trajectory, with two differences.  Each camera votes its own
    simulated stream, tiled to `n_events` (bench.py simulates camera 0's
    alone and both of its cameras vote it), and camera 1's trajectory is
    camera 0's composed on the right with the rig's baseline
    (`trajectory.apply_right`; bench.py adds [0.6, 0, 0] to the
    translations).  bench_torch.py:build_workload is bench.py's."""
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


def run_chunk(workload, spec, ts=0.5):
    """process_1 + get_depth_map of one chunk under `spec`, synchronised."""
    from dvs_mcemvs_torch import mapper as mappermod, pipeline
    from dvs_mcemvs_torch.ops import extract

    mappers, events, trajs, _ = workload
    vopts = pipeline.VotingOptions(packet_size=PACKET, backend=spec, pad_policy="bucket")
    res = pipeline.process_1(mappers, events, trajs, ts, stereo_fusion=2, vopts=vopts)
    dm = mappermod.get_depth_map(mappers[0], res.fused_dsi, extract.DepthMapOptions())
    if res.fused_dsi.device.type == "cuda":
        torch.cuda.synchronize()
    return res, dm


def check_dsis(res, workload, what) -> list:
    """Every DSI finite with the mapper's shape and some votes; returns the
    per-camera vote masses."""
    mappers, events, _, _ = workload
    Z, H, W = mappers[0].dsi_shape
    for name, dsi in [("fused", res.fused_dsi), *res.dsis.items()]:
        if tuple(dsi.shape) != (Z, H, W) or not bool(torch.isfinite(dsi).all()):
            raise AssertionError(f"{what}: DSI {name}: shape {tuple(dsi.shape)} or non-finite")
    masses = [float(res.dsis[f"camera{c}"].double().sum()) for c in range(len(events))]
    if not all(m > 0 for m in masses):
        raise AssertionError(f"{what}: a camera cast no votes: {masses}")
    return masses


def median_seconds(fn, runs):
    seconds = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        seconds.append(time.perf_counter() - t0)
    return float(np.median(seconds)), seconds


def chunk_phase(dev, workload, runs=N_TIMED):
    """One process_1 chunk with fresh launch counters, then `runs` timed
    chunks.  Returns (launch counts of the counted chunk, seconds list,
    per-camera vote masses)."""
    from dvs_mcemvs_torch.ops import voting_hist

    mappers, events, trajs, rig = workload
    m = mappers[0]
    n_ev = events[0].num
    spec = voting_hist.auto_backend_spec(
        rig.travel, n_ev // PACKET, m.vcam.fx, m.depth_vec.min_depth,
        m.depth_vec.max_depth, m.depth_vec.n)
    log(f"  auto-selected spec: {spec}")

    zero_counts()
    res, dm = run_chunk(workload, spec)
    counts = read_counts()
    launches = {name: counts[name] for name in
                ("bin_events", "banded_resample_sum", "banded_resample_fanin")}
    log(f"  launches in one chunk: {launches}")

    masses = check_dsis(res, workload, spec)
    Z = m.dsi_shape[0]
    for c, (ev, mass) in enumerate(zip(events, masses)):
        log(f"  camera{c} vote mass {mass:.6g} ({mass / (ev.num * Z):.4f} per event-plane)")
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

    _, seconds = median_seconds(lambda: run_chunk(workload, spec), runs)
    return launches, seconds, masses


# ---------------------------------------------------------------------------
# Phase 5: the BENCH16 golden gate on the literal spec
# ---------------------------------------------------------------------------


def golden_phase(dev, cfg_name="BENCH16", specs=(HEADLINE_SPEC, I8_SPEC, FLAT_SPEC),
                 budget_name="BUDGET_BENCH16"):
    """Score the port on a golden fixture as bench.py:golden_gate does,
    under each of `specs`; the first, the fixture's auto-selected spec, is
    gated by the budget, the others are only scored (the JAX package never
    gated them on this fixture).  Returns {spec: score}."""
    from dvs_mcemvs_torch import mapper as mappermod, pipeline
    from dvs_mcemvs_torch.ops import extract
    from dvs_mcemvs_torch.utils import golden

    cfg = getattr(golden, cfg_name)
    mappers, events, trajs, scene, ts_rv = golden.build_golden_fixture(cfg, device=dev)
    auto = golden.production_backend_spec(events, PACKET, cfg=cfg)
    if auto != specs[0]:
        raise AssertionError(f"{cfg_name} auto spec {auto} != {specs[0]}")
    budget = getattr(golden, budget_name)
    scores = {}
    for i, spec in enumerate(specs):
        vopts = pipeline.VotingOptions(packet_size=PACKET, backend=spec, pad_policy="bucket")
        res = pipeline.process_1(mappers, events, trajs, ts_rv, stereo_fusion=2, vopts=vopts)
        dm = mappermod.get_depth_map(mappers[0], res.fused_dsi, extract.DepthMapOptions())
        out = dict(spec=spec, **golden.gate(dm, res, scene, budget))
        log(f"  golden {cfg_name}{'' if i == 0 else ' (scored, not gated)'}: {json.dumps(out)}; "
            f"programs {program_summary()['programs']}")
        if i == 0 and not out["pass"]:
            raise AssertionError(f"golden gate failed: {out}")
        scores[spec] = out
    return scores


# ---------------------------------------------------------------------------
# Phase 6: the further spec forms, and the card against the CPU
# ---------------------------------------------------------------------------


def specs_phase(dev, workload, headline_masses, forms=SPEC_FORMS, runs=2):
    """The chunk once under each spec form with fresh launch counters: the
    kernels it must reach launched, its DSIs finite with the right shape,
    its per-camera vote mass within SPEC_MASS_REL of the headline spec's;
    then `runs` timed chunks after a warm-up.  Returns {spec: {launches,
    seconds, median_s, peak_gib, masses}}."""
    out = {}
    for spec, needed in forms.items():
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        zero_counts()
        res, _ = run_chunk(workload, spec)
        launches = read_counts()
        masses = check_dsis(res, workload, spec)
        rel = [m / h - 1.0 for m, h in zip(masses, headline_masses)]
        del res
        median, seconds = median_seconds(lambda: run_chunk(workload, spec), runs)
        peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else None
        log(f"  {spec}: launches {[launches[n] for n in needed]} of {list(needed)}; "
            f"mass vs headline {', '.join(f'{r:+.5f}' for r in rel)}; seconds per chunk "
            f"(median of {runs} after a warm-up) {median:.6f} "
            f"[{', '.join(f'{t:.6f}' for t in seconds)}]; peak device memory "
            f"{'not measured' if peak is None else f'{peak:.3f} GiB'}")
        if max(abs(r) for r in rel) > SPEC_MASS_REL:
            raise AssertionError(f"{spec}: vote mass off the headline spec's by {rel}")
        missing = [n for n in needed if launches[n] == 0]
        if missing:
            raise AssertionError(f"{spec}: kernels not launched: {missing}")
        out[spec] = dict(launches=launches, seconds=seconds, median_s=median,
                         peak_gib=peak, masses=masses)
    return out


def sort_vs_scatter_phase(workload, limit=SORT_VS_SCATTER) -> list:
    """`sort` against the exact `scatter` on the chunk: per camera relative
    L1 and vote mass below `limit` (the JAX package's float32 running sums
    miss this at the headline chunk).  Returns [(l1, mass_rel) per camera]."""
    got, _ = run_chunk(workload, "sort")
    want, _ = run_chunk(workload, "scatter")
    rows = []
    for name in sorted(k for k in want.dsis if k.startswith("camera")):
        g, w = got.dsis[name].double(), want.dsis[name].double()
        l1 = float((g - w).abs().sum() / w.abs().sum())
        mass = float(g.sum() / w.sum()) - 1.0
        log(f"  sort vs scatter {name}: relative L1 {l1:.3g}, mass {mass:+.3g}")
        if not l1 < limit or not abs(mass) < limit:
            raise AssertionError(f"sort {name} disagrees with the exact scatter")
        rows.append((l1, mass))
    return rows


def device_vs_cpu_phase(dev, specs=DEVICE_VS_CPU_SPECS, **size):
    """A small chunk under each of `specs` on `dev` and on the CPU (the
    kernels' plain versions): per-camera relative L1 and vote mass.
    Returns {spec: [(l1, mass_rel) per camera]}."""
    small = dict(n_events=16384, width=96, height=64, dim_z=20, n_pts=2000)
    small.update(size)
    on_dev = build_workload(dev, **small)
    on_cpu = build_workload(torch.device("cpu"), **small)
    out = {}
    for spec in specs:
        got, _ = run_chunk(on_dev, spec)
        want, _ = run_chunk(on_cpu, spec)
        rows = []
        for name in sorted(want.dsis):
            g = got.dsis[name].double().cpu()
            w = want.dsis[name].double()
            l1 = float((g - w).abs().sum() / w.abs().sum())
            mass = float(g.sum() / w.sum()) - 1.0
            rows.append((l1, mass))
            log(f"  {spec} {name}: {dev.type} vs cpu relative L1 {l1:.3g}, mass {mass:+.3g}")
            if not l1 < DEVICE_VS_CPU_L1 or not abs(mass) < DEVICE_VS_CPU_MASS:
                raise AssertionError(f"{spec} {name}: the card disagrees with the CPU")
        out[spec] = rows
    return out


# ---------------------------------------------------------------------------
# Phase 7: the dense binning form and the platform probes
# ---------------------------------------------------------------------------


def dense_phase(dev, workload, hs=HS_DENSE, group_size=16):
    """build_group_histograms on the chunk's camera-0 packets at a grid
    height that is not a multiple of 64 (the JAX package's dense binning
    kernel), with f32 and int8 taps.  Returns the binning launch count."""
    from dvs_mcemvs_torch import mapper as mappermod, pipeline
    from dvs_mcemvs_torch.ops import voting_hist

    mappers, events, trajs, _ = workload
    m = mappers[0]
    T_rv_w = pipeline.place_reference_view(trajs[0], 0.5)
    packets, _, _ = mappermod.warp_chunk(m, events[0], trajs[0], T_rv_w, PACKET,
                                         pad="bucket")
    ws = m.width + 2 * voting_hist.PAD_X
    ws += -ws % 128
    zero_counts()
    hists = [voting_hist.build_group_histograms(
        packets, group_size, hs, ws, voting_hist.PAD_X, voting_hist.PAD_Y, 1, dtype=dtype,
        out_dtype=torch.float32)[0] for dtype in (torch.bfloat16, torch.int8)]
    launches = read_counts()["bin_events"]
    masses = [float(h.double().sum()) for h in hists]
    log(f"  dense binning {tuple(hists[0].shape)}: f32-tap mass {masses[0]:.6g}, int8 "
        f"{masses[1]:.6g}; bin_events launches {launches}")
    if not all(bool(torch.isfinite(h).all()) for h in hists) or not min(masses) > 0:
        raise AssertionError("dense binning: non-finite or empty histograms")
    if abs(masses[1] / masses[0] - 1.0) > 1e-2:
        raise AssertionError(f"dense binning: int8 mass {masses[1]} vs {masses[0]}")
    return launches


def probe_phase(min_time=0.2):
    """scripts/probe_gpu.py's measurement with fresh launch counters.
    Returns (its numbers, the launch counts of its run)."""
    zero_counts()
    res = script("probe_gpu").measure(min_time, log=lambda msg: log("  " + msg))
    return res, read_counts()


# ---------------------------------------------------------------------------
# Phase 8: the temporal pipelines, full_seq, the multi-frame gate, the CLI
# ---------------------------------------------------------------------------


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak(dev) -> str:
    if dev.type != "cuda":
        return "not measured"
    return f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"


def _check_launched(what: str, launches: dict, needed=KERNELS_A_B) -> None:
    missing = [n for n in needed if launches[n] == 0]
    if missing:
        raise AssertionError(f"{what}: kernels not launched: {missing}")


def _timed(dev, what, fn, n_events, runs, smi="") -> tuple:
    """Run `fn` once with fresh launch counters (that run is the warm-up),
    then `runs` times; log its launches, seconds (median and every sample),
    Mev/s over `n_events` and peak memory.  Returns (first result, launches,
    median seconds)."""
    _reset_peak(dev)
    zero_counts()
    out = fn()
    _sync(dev)
    counts = read_counts()
    launches = {n: counts[n] for n in KERNELS_A_B}
    median, seconds = median_seconds(lambda: (fn(), _sync(dev)), runs)
    log(f"  {what}: launches {launches}; seconds (median of {runs} after a warm-up) "
        f"{median:.6f} [{', '.join(f'{t:.6f}' for t in seconds)}]; "
        f"{n_events / median / 1e6:.3f} Mev/s; peak device memory {_peak(dev)}"
        + (f"; {smi}" if smi else ""))
    return out, launches, median


def temporal_phase(dev, workload, masses, spec=HEADLINE_SPEC, intervals=N_INTERVALS,
                   runs=2, smi="", needed=KERNELS_A_B):
    """process_2 and process_5 on the chunk, with `intervals` sub-intervals,
    under AM and HM temporal fusion: every DSI finite with the mapper's
    shape, kernels A and B launched, and under AM each camera's temporal
    mass times `intervals` within TEMPORAL_MASS_REL of its process_1 mass
    `masses` on the same events.  Returns {(method, fusion): launches}."""
    from dvs_mcemvs_torch import pipeline

    mappers, events, trajs, _ = workload
    if any(e.num % intervals for e in events):
        raise ValueError(f"the chunk's events do not split into {intervals} equal parts")
    Z, H, W = mappers[0].dsi_shape
    vopts = pipeline.VotingOptions(packet_size=PACKET, backend=spec, pad_policy="bucket")
    out = {}
    for method in ("process_2", "process_5"):
        for fusion, name in ((pipeline.TEMPORAL_AM, "AM"), (pipeline.TEMPORAL_HM, "HM")):
            def run():
                return getattr(pipeline, method)(
                    mappers, events, trajs, 0.5, stereo_fusion=2, temporal_fusion=fusion,
                    num_intervals=intervals, vopts=vopts)

            what = f"{method} {name} ({intervals} sub-intervals, {spec})"
            res, launches, _ = _timed(dev, what, run, sum(e.num for e in events), runs, smi)
            for key, dsi in [("fused", res.fused_dsi), *res.dsis.items()]:
                if tuple(dsi.shape) != (Z, H, W) or not bool(torch.isfinite(dsi).all()):
                    raise AssertionError(f"{what}: DSI {key} has shape {tuple(dsi.shape)} "
                                         "or is not finite")
            if fusion == pipeline.TEMPORAL_AM:
                rel = [intervals * float(res.dsis[k].double().sum()) / m - 1.0
                       for k, m in zip(("left_temporal", "right_temporal"), masses)]
                log(f"  {what}: {intervals} x temporal mass vs process_1, per camera "
                    f"{', '.join(f'{r:+.5f}' for r in rel)}")
                if max(abs(r) for r in rel) > TEMPORAL_MASS_REL:
                    raise AssertionError(f"{what}: vote mass is not additive: {rel}")
            _check_launched(what, launches, needed)
            out[(method, name)] = launches
            # Free this step's planes, so the next step's peak is its own.
            del res, dsi
    return out


def full_seq_phase(dev, n_events=FULL_SEQ_EVENTS, duration=FULL_SEQ_DURATION,
                   skip=FULL_SEQ_SKIP, runs=2, smi="", needed=KERNELS_A_B, **size):
    """run_full_seq over the headline rig's streams tiled to `n_events` a
    camera, chunks `duration` long every `skip` of their time span, each
    chunk process_1 + get_depth_map on the CLI's auto spec; once from RAM
    and once from native event stores.  Both must give the same chunks.
    Returns {path: (chunk indices, launches, median seconds)}."""
    from dvs_mcemvs_torch import mapper as mappermod, pipeline
    from dvs_mcemvs_torch.io import evstore
    from dvs_mcemvs_torch.ops import extract, voting_hist

    mappers, events, trajs, rig = build_workload(dev, n_events=n_events, **size)
    t_lo = min(float(e.t[0]) for e in events)
    t_hi = max(float(e.t[-1]) for e in events)
    fopts = pipeline.FullSeqOptions(start_time=t_lo, stop_time=t_hi,
                                    duration=duration * (t_hi - t_lo),
                                    out_skip=skip * (t_hi - t_lo))
    # The CLI's auto spec for a chunk: the travel and the packets of one.
    ts = trajs[0].ts.cpu().numpy()
    m = mappers[0]
    spec = voting_hist.auto_backend_spec(
        rig.travel * fopts.duration / float(ts[-1] - ts[0]),
        max(1, int(n_events * duration) // PACKET), m.vcam.fx, m.depth_vec.min_depth,
        m.depth_vec.max_depth, m.depth_vec.n)
    vopts = pipeline.VotingOptions(packet_size=PACKET, backend=spec, pad_policy="bucket")

    def process(mps, evs, trs, t):
        res = pipeline.process_1(mps, evs, trs, t, stereo_fusion=2, vopts=vopts)
        res.extracted = mappermod.get_depth_map(mps[0], res.fused_dsi,
                                                extract.DepthMapOptions())
        return res

    def chunks(runner):
        idx = []
        for k, _, res in runner:
            if not bool(torch.isfinite(res.extracted.depth).all()):
                raise AssertionError(f"full_seq chunk {k}: depth is not finite")
            idx.append(k)
        return idx

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_evs_") as d:
        stores = []
        for i, ev in enumerate(events):
            evstore.write_store(os.path.join(d, f"events_{i}.evs"), ev)
            stores.append(evstore.EventStore(os.path.join(d, f"events_{i}.evs")))
        paths = {
            "RAM": lambda: chunks(pipeline.run_full_seq(mappers, events, trajs, fopts,
                                                        process)),
            "event store": lambda: chunks(pipeline.run_full_seq_stores(
                mappers, stores, trajs, fopts, process)),
        }
        # Events voted in a run: every chunk's, both cameras (Mev/s).
        n_chunk_ev = sum(ev.time_window(*w[:2]).num
                         for w in pipeline.full_seq_windows(fopts) for ev in events)
        for path, fn in paths.items():
            what = (f"full_seq from {path} (2 x {n_events} events, chunks of "
                    f"{fopts.duration:.4f} s every {fopts.out_skip:.4f} s, {spec})")
            held = program_summary()
            idx, launches, median = _timed(dev, what, fn, n_chunk_ev, runs, smi)
            now = program_summary()
            log(f"  {what}: {len(idx)} chunks {idx}; {len(idx) / median:.3f} chunks/s; "
                f"on programs: {now['captures'] - held['captures']} captured, "
                f"{now['replays'] - held['replays']} replays in its {runs + 1} runs, "
                f"{now['programs']} held")
            if dev.type == "cuda" and now["replays"] == held["replays"]:
                raise AssertionError(f"{what}: no chunk replayed a program")
            _check_launched(what, launches, needed)
            out[path] = (idx, launches, median)
        for s_ in stores:
            s_.close()
    if out["RAM"][0] != out["event store"][0] or len(out["RAM"][0]) < 2:
        raise AssertionError(f"full_seq chunks differ: RAM {out['RAM'][0]}, "
                             f"store {out['event store'][0]}")
    return out


def multiframe_phase(dev, cfg_name="FULL", gate=MULTIFRAME_GATE, needed=KERNELS_A_B):
    """The multi-frame golden gate of tests/test_golden.py on the port: the
    fixture's full_seq chunking (0.2 s chunks every 0.04 s over 0.4 s)
    under its auto spec, each frame's depth map scored against the analytic
    ground truth at its pose (stereo-visible, unambiguous pixels), the
    errors consolidated over all frames.  Returns the report."""
    from dvs_mcemvs_torch import mapper as mappermod, pipeline
    from dvs_mcemvs_torch.eval import dsec
    from dvs_mcemvs_torch.ops import extract, trajectory as trajmod
    from dvs_mcemvs_torch.utils import golden

    cfg = getattr(golden, cfg_name)
    mappers, events, trajs, scene, _ = golden.build_golden_fixture(cfg, device=dev)
    spec = golden.production_backend_spec(events, PACKET, cfg=cfg)
    vopts = pipeline.VotingOptions(packet_size=PACKET, backend=spec, pad_policy="bucket")
    fopts = pipeline.FullSeqOptions(start_time=0.0, stop_time=0.4, duration=0.2,
                                    out_skip=0.04)
    zero_counts()
    t0 = time.perf_counter()
    est, gt = [], []
    for _, ts_k, res in pipeline.run_full_seq(
            mappers, events, trajs, fopts,
            lambda mps, evs, trs, t: pipeline.process_1(mps, evs, trs, t, stereo_fusion=2,
                                                        vopts=vopts)):
        dm = mappermod.get_depth_map(mappers[0], res.fused_dsi, extract.DepthMapOptions())
        T_w_c, _ = trajmod.pose_at(trajs[0], ts_k)
        T_w_c1, _ = trajmod.pose_at(trajs[1], ts_k)
        g = golden.gt_depth_at_pose(scene, T_w_c, T_w_c_right=T_w_c1)
        est.append(np.ma.array(dm.depth.cpu().numpy(), mask=~(dm.mask.cpu().numpy() > 0)))
        gt.append(np.ma.array(g, mask=(g < 0.05)))
    seconds = time.perf_counter() - t0
    counts = read_counts()
    K = np.array([[cfg.fx, 0, cfg.width / 2 - 0.5], [0, cfg.fx, cfg.height / 2 - 0.5],
                  [0, 0, 1.0]])
    rig = dsec.DsecEvalRig(Q=np.eye(4), T_rect0_0=np.eye(4), K_target=K,
                           baseline=golden.BASELINE)
    rep = dsec.evaluate_sequence(est, gt, rig)
    out = {"spec": spec, "frames": rep["frames"],
           "median_rel": float(rep["median_err"]) / float(np.median(scene.gt_depth)),
           "mean_err": float(rep["mean_err"]), "bad_p": float(rep["metrics"].bad_p),
           "seconds": seconds, "launches": {n: counts[n] for n in KERNELS_A_B}}
    out["pass"] = bool(out["frames"] >= gate["frames"] and out["median_rel"] < gate["median_rel"]
                       and out["mean_err"] < gate["mean_err"] and out["bad_p"] < gate["bad_p"])
    log(f"  multi-frame golden {cfg_name}: {json.dumps(out)}; gate {json.dumps(gate)}")
    _check_launched(f"multi-frame golden {cfg_name}", out["launches"], needed)
    if not out["pass"]:
        raise AssertionError(f"multi-frame golden gate failed: {out}")
    return out


def _plane_distance(path: str, planes=(1.5, 2.5)) -> float:
    """Median distance of a depth-point file's depths to the nearer plane;
    raises at 100 points or fewer."""
    d = np.atleast_2d(np.loadtxt(path)).reshape(-1, 3)[:, 2]
    if d.size <= 100:
        raise AssertionError(f"{path}: {d.size} points")
    return float(np.median(np.min(np.abs(d[:, None] - np.asarray(planes)[None]), axis=1)))


def cli_phase(dev, workdir, needed=KERNELS_A_B):
    """`dvs_mcemvs_torch.cli.main` in this process on the esim fixture under
    configs/synthetic/esim_stereo.conf with the paths overridden: process
    1, 2 and 5 single-shot, and full_seq (two chunks) with checkpoint, two
    save workers and the event store, run twice -- the second run resumes
    every chunk and launches nothing.  Each run exits 0 and writes the
    artifacts tests/test_cli.py checks, its fused depth points within 0.2 m
    of the scene's 1.5 / 2.5 m planes (median).  Returns {run: launches}."""
    from dvs_mcemvs_torch import cli
    from dvs_mcemvs_torch.utils import synthetic

    paths = synthetic.write_fixture(os.path.join(workdir, "data"),
                                    rig=synthetic.esim_like_rig(travel=0.4))
    base = [f"--flagfile={os.path.join(HERE, 'configs', 'synthetic', 'esim_stereo.conf')}",
            f"--bag_filename_left={paths['events0']}",
            f"--bag_filename_right={paths['events1']}",
            f"--bag_filename_pose={paths['poses']}",
            f"--platform={'cuda' if dev.type == 'cuda' else 'cpu'}"]
    full_seq = ["--process_method=1", "--full_seq", "--start_time_s=0", "--stop_time_s=1",
                "--duration=0.5", "--out_skip=0.4", "--checkpoint", "--save_workers=2",
                "--use_event_store", "--nosave_pointcloud"]
    runs = [("process_1", "p1", ["--process_method=1", "--save_mono", "--save_dsi"]),
            ("process_2", "p2", ["--process_method=2", "--num_intervals=2", "--save_dsi",
                                 "--nosave_pointcloud"]),
            ("process_5", "p5", ["--process_method=5", "--num_intervals=2", "--save_dsi"]),
            ("full_seq", "fs", full_seq), ("full_seq resumed", "fs", full_seq)]
    out = {}
    for name, sub, extra in runs:
        out_dir = os.path.join(workdir, sub)
        zero_counts()
        t0 = time.perf_counter()
        rc = cli.main(base + [f"--out_path={out_dir}/"] + extra)
        _sync(dev)
        seconds = time.perf_counter() - t0
        counts = read_counts()
        launches = {n: counts[n] for n in KERNELS_A_B}
        files = sorted(os.listdir(out_dir))
        fused = [f for f in files if f.endswith("depth_points_fused.txt")]
        dist = [_plane_distance(os.path.join(out_dir, f)) for f in fused]
        log(f"  cli {name}: exit {rc}, {seconds:.3f} s, launches {launches}, {len(files)} "
            f"files, fused depth median distance to the planes "
            f"{', '.join(f'{x:.4f}' for x in dist)} m")
        if rc != 0 or not fused or max(dist) >= 0.2:
            raise AssertionError(f"cli {name}: exit {rc}, plane distances {dist}")
        need = {"events_0.png", "events_1.png", "run_flags.conf"}
        suffixes = []
        if sub == "p1":
            need |= {"dsi_fused.npy", "pointcloud.pcd"}
            suffixes = ["camera0", "camera1"]
            dsi = np.load(os.path.join(out_dir, "dsi_fused.npy"))
            if dsi.shape != (40, 180, 240):
                raise AssertionError(f"cli {name}: DSI dump shape {dsi.shape}")
        elif sub in ("p2", "p5"):
            need |= {"dsi_fused_0_temporalfusion.npy", "dsi_fused_1_temporalfusion.npy",
                     "dsi_stereo_temporalfusion.npy",
                     "dsi_stereo_temporalfusion_camera_time.npy"}
            suffixes = ["0_000", "0_001", "1_000", "1_001", "left_temporal_4",
                        "right_temporal_4", "stereo_temporal_4", "stereo_temporal_camera_time4"]
        else:
            # full_seq ran from the native store the flag asks for.
            need |= {".events_0.evs", ".events_1.evs", "checkpoint.json"}
        missing = sorted(need - set(files)) + [
            s_ for s_ in suffixes if not any(f.endswith(f"depth_points_{s_}.txt") for f in files)]
        if len(fused) != (2 if sub == "fs" else 1) or missing:
            raise AssertionError(f"cli {name}: {len(fused)} fused maps, missing {missing}")
        if name == "full_seq resumed":
            if any(launches.values()):
                raise AssertionError(f"cli {name}: a resumed chunk launched kernels: {launches}")
        else:
            _check_launched(f"cli {name}", launches, needed)
        out[name] = launches
    return out


# ---------------------------------------------------------------------------
# Phase 9: MVSEC presets from a ROS1 bag, the focus collapses, a deep DSI
# ---------------------------------------------------------------------------


def mvsec_rig(width=346, height=260):
    """The synthetic two-plane rig at MVSEC's DAVIS size (346 x 260, f = 226
    px, a 10 cm baseline), moving 0.4 m/s past planes at 2.0 and 4.5 m,
    inside the presets' 1-6.5 m."""
    from dvs_mcemvs_torch.ops.camera import PinholeCamera
    from dvs_mcemvs_torch.utils import synthetic

    f = 226.0 * width / 346
    cam = PinholeCamera(width=width, height=height, fx=f, fy=f, cx=width / 2, cy=height / 2)
    return synthetic.SyntheticRig(cam=cam, baseline=0.1, travel=0.4, plane_depths=(2.0, 4.5))


def bag_phase(dev, workdir, rig=None, n_pts=BAG_PTS, n_samples=BAG_SAMPLES,
              seconds=BAG_SECONDS, extra=(), min_chunks=PRESET_MIN_CHUNKS,
              needed=KERNELS_A_B, smi="") -> dict:
    """The MVSEC presets of MVSEC_PRESETS through `dvs_mcemvs_torch.cli.main`
    on a ROS1 bag written as MVSEC ships one: the rig's events on
    /davis/left/events and /davis/right/events (`n_samples` sample times of
    `n_pts` points over `seconds`), its poses on /davis/left/pose, and a
    kalibr camchain for yaml_mvsec.  Each preset runs with its bag, calib
    and output paths and its time window set to the bag's span (and the
    flags `extra`); each must exit 0, write at least `min_chunks` fused
    depth maps of more than 100 points each whose median distance to the
    planes is below PLANE_DIST_M, and launch the kernels `needed`.  Logs
    the bag's size, and for each run the bag's read time and ingest rate
    (both event topics, by `io.events.read_events_rosbag`, before the run)
    and the run's seconds, chunks per second, launches and peak memory.
    Returns {preset: report}."""
    from dvs_mcemvs_torch import cli
    from dvs_mcemvs_torch.io import events as eventsmod
    from dvs_mcemvs_torch.utils import synthetic

    rig = rig or mvsec_rig()
    t0 = time.perf_counter()
    paths = synthetic.write_bag_fixture(os.path.join(workdir, "mvsec"), rig=rig, n_pts=n_pts,
                                        n_samples=n_samples, duration=seconds,
                                        t0=1_506_117_000.0)
    counts = [ev.num for ev in paths["events"]]
    log(f"  bag: {os.path.getsize(paths['bag']) / 2**20:.1f} MiB, events a camera {counts} "
        f"over {seconds} s, {rig.cam.width}x{rig.cam.height}; written in "
        f"{time.perf_counter() - t0:.2f} s")
    log(f"  cut: the presets' window (55 s of indoor_flying1) is the bag's {seconds} s"
        + (f"; also overridden: {' '.join(extra)}" if extra else ""))
    out = {}
    for name, preset in MVSEC_PRESETS.items():
        t0 = time.perf_counter()
        for topic in paths["topics"]:
            eventsmod.read_events_rosbag(paths["bag"], topic)
        read_s = time.perf_counter() - t0
        log(f"  {name}: bag read, both event topics, {read_s:.3f} s, "
            f"{sum(counts) / read_s / 1e6:.3f} Mev/s of ingest")
        out_dir = os.path.join(workdir, f"mvsec_{name}")
        args = [f"--flagfile={os.path.join(HERE, preset)}", f"--bag_filename={paths['bag']}",
                f"--calib_path={paths['camchain']}", f"--out_path={out_dir}/",
                "--start_time_s=0", f"--stop_time_s={seconds}",
                f"--platform={'cuda' if dev.type == 'cuda' else 'cpu'}", *extra]
        _reset_peak(dev)
        zero_counts()
        t0 = time.perf_counter()
        rc = cli.main(args)
        _sync(dev)
        run_s = time.perf_counter() - t0
        launches = {n: read_counts()[n] for n in KERNELS_A_B}
        fused = sorted(f for f in os.listdir(out_dir) if f.endswith("depth_points_fused.txt"))
        dist = [_plane_distance(os.path.join(out_dir, f), rig.plane_depths) for f in fused]
        n_pts_min = min(np.atleast_2d(np.loadtxt(os.path.join(out_dir, f))).shape[0]
                        for f in fused) if fused else 0
        what = f"preset {preset}"
        log(f"  {what}: exit {rc}, {len(fused)} chunks in {run_s:.3f} s of the whole run "
            f"(the bag read whole into RAM, voting, extraction, saves), "
            f"{len(fused) / run_s:.3f} chunks/s; "
            f"launches {launches}; peak device memory {_peak(dev)}; fused depth median "
            f"distance to the planes, worst chunk {max(dist, default=float('nan')):.4f} m; "
            f"fewest points a chunk {n_pts_min}" + (f"; {smi}" if smi else ""))
        if rc != 0 or len(fused) < min_chunks or max(dist) >= PLANE_DIST_M:
            raise AssertionError(f"{what}: exit {rc}, {len(fused)} chunks, distances {dist}")
        _check_launched(what, launches, needed)
        out[name] = dict(chunks=len(fused), seconds=run_s, launches=launches, dist=max(dist),
                         read_s=read_s)
    return out


def collapse_phase(dev, fused_cpu, mapper, runs=2) -> dict:
    """`collapse_method` 0-4 on one fused DSI, on the card against the CPU:
    the collapse's confidence within COLLAPSE_RTOL of each value and its
    depth indices equal on COLLAPSE_EQUAL of the pixels; get_depth_map's
    seconds with each method (median of `runs` after a warm-up).  Returns
    {method: (seconds, largest relative error, share of equal indices)}."""
    from dvs_mcemvs_torch import mapper as mappermod
    from dvs_mcemvs_torch.ops import extract, grid

    on_dev = fused_cpu.to(dev)
    out = {}
    for method in range(5):
        conf, idx = grid.collapse(on_dev, method)
        t0 = time.perf_counter()
        want_conf, want_idx = grid.collapse(fused_cpu, method)
        cpu_s = time.perf_counter() - t0
        g, w = conf.cpu().double(), want_conf.double()
        excess = float(((g - w).abs() - COLLAPSE_RTOL * w.abs()).max())
        rel = float(((g - w).abs() / w.abs().clamp(min=1e-30)).max())
        equal = float((idx.cpu() == want_idx).double().mean())
        opts = extract.DepthMapOptions(collapse_method=method)
        median, _ = median_seconds(
            lambda: (mappermod.get_depth_map(mapper, on_dev, opts), _sync(dev)), runs + 1)
        log(f"  collapse_method {method}: card vs cpu confidence max relative error {rel:.3g}, "
            f"equal indices {equal:.6f}; get_depth_map {median:.6f} s (median of {runs + 1}); "
            f"the cpu's collapse {cpu_s:.3f} s")
        if excess > 0 or equal < COLLAPSE_EQUAL:
            raise AssertionError(f"collapse_method {method}: the card disagrees with the CPU")
        out[method] = (median, rel, equal)
    return out


def deep_chunk_phase(dev, workload, dim_z=DEEP_Z, needed=KERNELS_A_B) -> dict:
    """One process_1 chunk of the headline workload's events at `dim_z`
    planes over its depth range (more than 256: the extraction's median
    takes its gather + sort path) under the headline spec; its filtered
    depth indices must equal the CPU's extraction of the same DSI.  Returns
    its report."""
    from dvs_mcemvs_torch import mapper as mappermod
    from dvs_mcemvs_torch.ops import extract

    mappers, events, trajs, rig = workload
    dv = mappers[0].depth_vec
    deep = mappermod.make_mapper(rig.cam, mappermod.DsiShape(
        dim_z=dim_z, min_depth=dv.min_depth, max_depth=dv.max_depth))
    workload = [deep, deep], events, trajs, rig
    _reset_peak(dev)
    zero_counts()
    t0 = time.perf_counter()
    res, dm = run_chunk(workload, HEADLINE_SPEC)
    seconds = time.perf_counter() - t0
    launches = {n: read_counts()[n] for n in KERNELS_A_B}
    t0 = time.perf_counter()
    want = mappermod.get_depth_map(deep, res.fused_dsi.cpu(), extract.DepthMapOptions())
    cpu_s = time.perf_counter() - t0
    equal = bool((dm.depth_indices.cpu() == want.depth_indices).all())
    log(f"  process_1 chunk at {dim_z} planes ({HEADLINE_SPEC}): {seconds:.6f} s (first run), "
        f"launches {launches}, peak device memory {_peak(dev)}; filtered indices equal to the "
        f"cpu's ({cpu_s:.3f} s): {equal}; {int((dm.mask > 0).sum())} masked pixels, largest "
        f"index {int(dm.depth_indices.max())}")
    if not equal:
        raise AssertionError(f"{dim_z}-plane chunk: the card's filtered indices differ")
    _check_launched(f"{dim_z}-plane chunk", launches, needed)
    return dict(seconds=seconds, launches=launches)


# ---------------------------------------------------------------------------
# Phase 10: the distributed path (dvs_mcemvs_torch.parallel and the CLI's ranks)
# ---------------------------------------------------------------------------


def sharded_args(workload, mesh, tables, events=None):
    """This rank's step arguments for the headline chunk (or `events`), as
    the CLI's feed builds them: every camera's events padded to the bucket
    and cut to the rank's block, and `tables` (`sharded.device_step_tables`,
    built once) with the chunk's reference view."""
    from dvs_mcemvs_torch import mapper as mappermod, pipeline
    from dvs_mcemvs_torch.parallel import sharded

    mappers, chunk, trajs, _ = workload
    events = chunk if events is None else events
    n_event = mesh.size(0)
    cap = mappermod.bucket_capacity(max(e.num for e in events), n_event * PACKET)
    T_rv_w = pipeline.place_reference_view(trajs[0], 0.5)
    return sharded.local_inputs(mesh, sharded.sharded_step_inputs(
        mappers, events, trajs, T_rv_w, n_event, PACKET, capacity=cap, tables=tables))


def sharded_chunk(workload, mesh, step, tables):
    """The headline chunk through this rank's sharded `step` on `mesh`: the
    padded inputs, this rank's event block, the step; synchronised."""
    out = step(*sharded_args(workload, mesh, tables))
    _sync(out["dsi"].device)
    return out


def make_headline_step(workload, mesh, spec=HEADLINE_SPEC, kind="full"):
    from dvs_mcemvs_torch.parallel import sharded

    cfg = sharded.ShardedStepConfig(fusion_method=2, packet_size=PACKET, backend=spec)
    make = sharded.make_sharded_step if kind == sharded.FULL else \
        sharded.make_sharded_voting_step
    return make(mesh, sharded.rig_spec_from_mappers(workload[0]), cfg)


def compare_sharded(what, out, mesh, ref_dsi, ref_idx) -> dict:
    """This rank's block of the fused DSI against the same planes of
    process_1's (relative L1, vote mass) and its depth indices against
    process_1 + get_depth_map's; raises beyond DIST_L1, DIST_MASS,
    DIST_EQUAL."""
    n_plane = mesh.size(1)
    zb = ref_dsi.shape[0] // n_plane
    pi = mesh.get_local_rank("plane")
    want = ref_dsi[pi * zb:(pi + 1) * zb].double()
    got = out["dsi"].double()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: DSI block {tuple(got.shape)} or not finite")
    l1 = float((got - want).abs().sum() / want.abs().sum())
    mass = float(got.sum() / want.sum()) - 1.0
    equal = float((out["depth_indices"] == ref_idx).double().mean())
    log(f"  {what}: planes {pi * zb}-{(pi + 1) * zb - 1}: fused-DSI relative L1 {l1:.3g}, "
        f"mass {mass:+.3g}, depth indices equal on {equal:.5f} of the pixels (limits "
        f"{DIST_L1:g}, {DIST_MASS:g}, {DIST_EQUAL:g})")
    if l1 >= DIST_L1 or abs(mass) >= DIST_MASS or equal < DIST_EQUAL:
        raise AssertionError(f"{what}: the sharded chunk disagrees with process_1")
    return dict(l1=l1, mass=mass, equal=equal)


def timed_sharded(dev, what, workload, mesh, step, tables, runs, needed=KERNELS_A_B):
    """One counted sharded chunk (launches from zero), then the median
    seconds of `runs` more.  Returns (first output, launches, median)."""
    zero_counts()
    out = sharded_chunk(workload, mesh, step, tables)
    counts = read_counts()
    launches = {n: counts[n] for n in KERNELS_A_B}
    _check_launched(what, launches, needed)
    median, seconds = median_seconds(lambda: sharded_chunk(workload, mesh, step, tables), runs)
    log(f"  {what}: launches {launches}; seconds a chunk (median of {runs} after a warm-up) "
        f"{median:.6f} [{', '.join(f'{t:.6f}' for t in seconds)}]")
    return out, launches, median


def _int8_form(spec: str) -> str:
    """`spec` with int8 binning (I8_SPEC for the headline spec)."""
    return spec.replace(",pl", ",i8,pl")


def _step_outputs(out) -> dict:
    return out if isinstance(out, dict) else {"dsi": out}


def sharded_program_vs_eager(dev, what, workload, mesh, tables, spec, kind) -> dict:
    """This rank's step of `kind` under `spec` inside `mapper.eager()`, then
    on its program (captured on the first call unless held; the next call
    replays it): the DSI block against eager's (a hist spec equal to the
    bit, `scatter` within phase 3's tolerance and mass 1e-3), the depth
    indices equal on PROGRAM_EQUAL of the pixels, a replay's launch counts
    equal to eager's and its graph launches equal to the step's compute
    segments (none on the CPU).  Raises beyond these."""
    from dvs_mcemvs_torch import graphs, mapper as mappermod
    from dvs_mcemvs_torch.parallel import sharded

    step = make_headline_step(workload, mesh, spec, kind)
    args = sharded_args(workload, mesh, tables)

    def counted(fn):
        zero_counts()
        replays = graphs.Graph.replays_total
        out = _step_outputs(fn())
        _sync(dev)
        counts = read_counts()
        return out, {n: counts[n] for n in KERNELS_A_B}, graphs.Graph.replays_total - replays

    with mappermod.eager():
        want, eager_counts, _ = counted(lambda: step(*args))
    counted(lambda: step(*args))
    got, counts, replayed = counted(lambda: step(*args))
    cfg = sharded.ShardedStepConfig(fusion_method=2, packet_size=PACKET, backend=spec)
    plan = sharded.segment_plan(sharded.rig_spec_from_mappers(workload[0]), cfg, kind,
                                (mesh.size(0), mesh.size(1)), mesh.get_local_rank("plane"))
    segments = sum(isinstance(seg, list) for seg in plan) if dev.type == "cuda" else 0
    name = f"{what}, {kind} step, {spec}, program vs eager"
    if counts != eager_counts or replayed != segments:
        raise AssertionError(f"{name}: a replay launched {counts} in {replayed} graphs; "
                             f"eager {eager_counts}, segments {segments}")
    check = compare_exact if spec.startswith("hist") else compare
    err = check(f"{name}, DSI block", got["dsi"], want["dsi"])
    out = dict(err=err, launches=counts, graphs=replayed)
    if kind == sharded.FULL:
        out["equal"] = float((got["depth_indices"] == want["depth_indices"]).double().mean())
        if out["equal"] < PROGRAM_EQUAL:
            raise AssertionError(f"{name}: depth indices equal on {out['equal']}")
    log(f"  {name}: launches {counts} (eager {eager_counts}) from {replayed} graph "
        f"launches; depth indices equal on {out.get('equal', 'n/a')}")
    return out


def refused_sharded_weights(what, workload, mesh, tables, spec) -> dict:
    """A weight of 1.5 through the steps under the int8 `spec`: the full
    step, which passes its weights as binary, raises the binary check at
    its own fault read; the voting step, where only the int8 check
    applies, leaves the flag to its caller's `mapper.check_faults()`,
    which raises it.  A clean step of each then runs and checks clean."""
    from dvs_mcemvs_torch import mapper as mappermod
    from dvs_mcemvs_torch.kernels import binning
    from dvs_mcemvs_torch.parallel import sharded

    refused = list(sharded_args(workload, mesh, tables))
    refused[3] = refused[3].copy()
    refused[3][0, refused[3].shape[1] // 2] = 1.5
    out = {}
    for kind, check, want in ((sharded.FULL, "binary", binning.WEIGHT_FAULTS[0]),
                              (sharded.VOTING, "int8", binning.WEIGHT_FAULTS[1])):
        step = make_headline_step(workload, mesh, spec, kind)
        try:
            step(*refused)
            mappermod.check_faults()
        except ValueError as e:
            out[f"refused_{check}"] = str(e)
        else:
            raise AssertionError(f"{what}: a {kind} step of refused weights ran clean")
        if out[f"refused_{check}"] != want:
            raise AssertionError(f"{what}: the {kind} step raised "
                                 f"{out[f'refused_{check}']!r}, not the {check} check")
        step(*sharded_args(workload, mesh, tables))
        mappermod.check_faults()
        log(f"  {what}: refused weights, {kind} step under {spec} ({check} check): raised "
            f"{out[f'refused_{check}']!r}; the next step ran clean")
    return out


def sharded_programs_phase(dev, what, workload, mesh, tables, spec, runs) -> dict:
    """Phase 10's programs on this rank of `mesh`: the full step under
    `spec`, its int8 form and `scatter`, and the voting step under `spec`,
    each against eager (`sharded_program_vs_eager`); a returned result
    unchanged by the next replay (on other events); refused weights raise
    the binary check in the full step and the int8 one in the voting step
    (`refused_sharded_weights`); seconds a chunk of the full step on
    programs and eagerly, in turns after the warm-up of each, and on the
    card one profiled chunk of each (scripts/profile_torch_chunk.py); the
    capture seconds of each program held."""
    from dvs_mcemvs_torch import graphs, mapper as mappermod
    from dvs_mcemvs_torch.parallel import sharded

    res = {f"{kind} {s}": sharded_program_vs_eager(dev, what, workload, mesh, tables, s, kind)
           for s, kind in ((spec, sharded.FULL), (_int8_form(spec), sharded.FULL),
                           ("scatter", sharded.FULL), (spec, sharded.VOTING))}

    step = make_headline_step(workload, mesh, spec)
    first = step(*sharded_args(workload, mesh, tables))
    kept = {k: v.clone() for k, v in first.items()}
    swapped = [workload[1][1], workload[1][0]]
    replays = graphs.Graph.replays_total
    second = step(*sharded_args(workload, mesh, tables, swapped))
    _sync(dev)
    same = all(bool(torch.equal(first[k], kept[k])) for k in kept)
    differ = not bool(torch.equal(first["dsi"], second["dsi"]))
    log(f"  {what}: a result after the next replay (other events): unchanged {same}, the "
        f"new one differs {differ}; graph launches {graphs.Graph.replays_total - replays}")
    if not (same and differ):
        raise AssertionError(f"{what}: a sharded program's result is not fresh")

    res.update(refused_sharded_weights(what, workload, mesh, tables, _int8_form(spec)))

    def chunk(mode):
        with mappermod.eager() if mode == "eager" else contextlib.nullcontext():
            sharded_chunk(workload, mesh, step, tables)

    samples = {"programs": [], "eager": []}
    for mode in samples:
        chunk(mode)
    for i in range(runs):
        for mode in (("programs", "eager") if i % 2 == 0 else ("eager", "programs")):
            t0 = time.perf_counter()
            chunk(mode)
            samples[mode].append(time.perf_counter() - t0)
    for mode, secs in samples.items():
        res[f"{mode}_s"] = float(np.median(secs))
        log(f"  {what}: full step {spec} on {mode} (median of {runs}, in turns): "
            f"{res[f'{mode}_s']:.6f} s [{', '.join(f'{t:.6f}' for t in secs)}]")
    if dev.type == "cuda":
        prof = script("profile_torch_chunk")
        for mode in samples:
            out = prof.profile_sharded_chunk(workload, mesh, step, tables, mode == "eager")
            prof.report(out, f"  {what}: profiled full step, {mode}", top=6, log=log)
            res[f"{mode}_idle_share"] = out["idle_share"]
    res["capture_s"] = [round(p.capture_s, 3) for p in sharded.programs()]
    log(f"  {what}: sharded programs held {len(res['capture_s'])}, capture seconds each "
        f"{res['capture_s']}")
    return res


def _dist_rank(rank, world, coordinator, out_dir, dev_name, size, spec, runs, needed):
    """Phase 10 (b), one rank of two sharing the card: the headline chunk on
    meshes DIST_MESHES against process_1 on the same card, the programs
    against eager on each, and the all-reduce of one fused-DSI-sized tensor
    over the event group."""
    import torch.distributed as dist

    from dvs_mcemvs_torch.parallel import mesh as meshmod, sharded

    dev = torch.device(dev_name)
    meshmod.init_distributed(coordinator, world, rank, dev)
    try:
        workload = build_workload(dev, **size)
        tables = sharded.device_step_tables(workload[0], workload[2], dev)
        ref, dm = run_chunk(workload, spec)
        result = {"backend": dist.get_backend()}
        for shape, mesh_needs in DIST_MESHES.items():
            name = f"{shape[0]}x{shape[1]}"
            mesh = meshmod.make_mesh(*shape, device=dev)
            what = f"rank {rank} of {world}, mesh {shape}"
            out, launches, median = timed_sharded(
                dev, what, workload, mesh, make_headline_step(workload, mesh, spec), tables,
                runs, tuple(n for n in mesh_needs if n in needed))
            stats = compare_sharded(what, out, mesh, ref.fused_dsi, dm.depth_indices)
            progs = sharded_programs_phase(dev, what, workload, mesh, tables, spec, runs)
            result[name] = dict(launches=launches, seconds=median, programs=progs, **stats)
            if shape[0] > 1:
                t = torch.ones_like(ref.fused_dsi)
                group = mesh.get_group("event")

                def reduce():
                    dist.all_reduce(t, group=group)
                    _sync(dev)

                reduce()
                med, secs = median_seconds(reduce, runs)
                result["all_reduce_s"] = med
                log(f"  rank {rank}: all_reduce of a {tuple(t.shape)} f32 DSI over "
                    f"{result['backend']}: median {med:.6f} s [{', '.join(f'{x:.6f}' for x in secs)}]")
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        meshmod.shutdown_distributed()


def truncate_fixture(paths, packets):
    """Cut each camera's events of a written fixture to `packets` packets
    (a power of two: the processes' slices and their groups then line up
    with one process's)."""
    from dvs_mcemvs_torch.io import events as eventsmod

    for key in ("events0", "events1"):
        ev = eventsmod.read_events(paths[key])
        if ev.num < packets * PACKET_CLI:
            raise AssertionError(f"{key}: {ev.num} events < {packets} packets")
        eventsmod.write_events_npz(paths[key], ev.slice(0, packets * PACKET_CLI))


def cli_depth_indices(dsi_path, argv):
    """The filtered depth indices that the CLI run of `argv` extracts from
    the fused DSI it saved at `dsi_path`."""
    from dvs_mcemvs_torch.config import parse_args
    from dvs_mcemvs_torch.ops import extract
    from dvs_mcemvs_torch.ops.depth_vector import DepthVector

    cfg = parse_args(argv)
    opts = extract.DepthMapOptions(
        adaptive_threshold_kernel_size=cfg.adaptive_threshold_kernel_size,
        adaptive_threshold_c=cfg.adaptive_threshold_c,
        median_filter_size=cfg.median_filter_size, max_confidence=cfg.max_confidence,
        collapse_method=cfg.collapse_method)
    dv = DepthVector(cfg.depth_sampling, cfg.min_depth, cfg.max_depth, cfg.dimZ)
    dsi = torch.as_tensor(np.load(dsi_path))
    return extract.get_depth_map_from_dsi(dsi, dv, opts).depth_indices


def cli_ranks_phase(dev, workdir, timeout=300) -> dict:
    """Phase 10 (c): `python -m dvs_mcemvs_torch.cli` as two processes
    (--coordinator, --num_processes=2, --process_id) on the esim fixture
    under process_method 1 and 2, against the same run in one process: rank
    0's fused depth within PLANE_DIST_M of the planes, and the depth indices
    that the CLI's extraction takes from its fused DSI equal to the
    one-process run's on DIST_EQUAL of the pixels."""
    import signal

    from dvs_mcemvs_torch import cli
    from dvs_mcemvs_torch.parallel.mesh import free_port
    from dvs_mcemvs_torch.utils import synthetic

    paths = synthetic.write_fixture(os.path.join(workdir, "data"),
                                    rig=synthetic.esim_like_rig(travel=0.4))
    truncate_fixture(paths, CLI_PACKETS)
    platform = "cuda" if dev.type == "cuda" else "cpu"
    base = [f"--flagfile={os.path.join(HERE, 'configs', 'synthetic', 'esim_stereo.conf')}",
            f"--bag_filename_left={paths['events0']}",
            f"--bag_filename_right={paths['events1']}",
            f"--bag_filename_pose={paths['poses']}", f"--platform={platform}",
            f"--packet_size={PACKET_CLI}", "--save_dsi", "--nosave_pointcloud"]
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = {}
    for pm, extra in ((1, ["--process_method=1"]),
                      (2, ["--process_method=2", "--num_intervals=2"])):
        one = os.path.join(workdir, f"one_p{pm}")
        t0 = time.perf_counter()
        if cli.main(base + extra + [f"--out_path={one}/"]) != 0:
            raise AssertionError(f"cli process_{pm}: the one-process run failed")
        t_one = time.perf_counter() - t0
        two = os.path.join(workdir, f"two_p{pm}")
        port = free_port()
        logs, procs = [], []
        t0 = time.perf_counter()
        for rank in range(2):
            logs.append(os.path.join(workdir, f"p{pm}_rank{rank}.log"))
            with open(logs[-1], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "dvs_mcemvs_torch.cli", *base, *extra,
                     f"--out_path={two}/", f"--coordinator=127.0.0.1:{port}",
                     "--num_processes=2", f"--process_id={rank}"],
                    cwd=HERE, env=env, stdout=f, stderr=subprocess.STDOUT,
                    start_new_session=True))
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                    break
                time.sleep(0.2)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=30)
        t_two = time.perf_counter() - t0
        text = [open(path).read() for path in logs]
        if any(proc.returncode != 0 for proc in procs):
            raise AssertionError(f"cli process_{pm} on two processes: exits "
                                 f"{[proc.returncode for proc in procs]}\n{text[0][-3000:]}\n"
                                 f"{text[1][-3000:]}")
        backend = [ln.rsplit("backend ", 1)[1] for ln in text[0].splitlines()
                   if "dvs_mcemvs_torch.parallel.mesh" in ln and "backend" in ln]
        fused = [f for f in os.listdir(two) if f.endswith("depth_points_fused.txt")]
        dist_m = _plane_distance(os.path.join(two, fused[0]))
        a, b = (cli_depth_indices(os.path.join(d, "dsi_fused.npy"), base + extra)
                for d in (one, two))
        equal = float((a == b).double().mean())
        log(f"  cli process_{pm}, two processes on one {platform} device: backend "
            f"{backend}, {t_two:.3f} s (one process in this one: {t_one:.3f} s); fused depth "
            f"median distance to the planes {dist_m:.4f} m; depth indices equal to the "
            f"one-process run's on {equal:.5f} of the pixels")
        if dist_m >= PLANE_DIST_M or equal < DIST_EQUAL:
            raise AssertionError(f"cli process_{pm} on two processes: distance {dist_m}, "
                                 f"equal {equal}")
        out[pm] = dict(seconds=t_two, equal=equal, distance=dist_m)
    return out


def distributed_phase(dev, workload, spec=HEADLINE_SPEC, runs=DIST_RUNS, rank_size=None,
                      needed=KERNELS_A_B, smi="") -> dict:
    """Phase 10: (a) the sharded step at world size 1 (NCCL on the card) on
    the headline chunk against phase 4's process_1; (b) two ranks sharing
    this device (gloo) on meshes (2, 1) and (1, 2); (c) the CLI as two
    processes.  Returns what each part measured."""
    import torch.distributed as dist

    from dvs_mcemvs_torch.parallel import mesh as meshmod, sharded

    ref, dm = run_chunk(workload, spec)
    tables = sharded.device_step_tables(workload[0], workload[2], dev)
    meshmod.init_distributed(f"127.0.0.1:{meshmod.free_port()}", 1, 0, dev)
    try:
        backend = dist.get_backend()
        mesh = meshmod.make_mesh(1, 1, device=dev)
        what = f"(a) one rank over {backend}, mesh (1, 1), {spec}"
        out, launches, median = timed_sharded(dev, what, workload, mesh,
                                               make_headline_step(workload, mesh, spec),
                                               tables, runs, needed)
        stats = compare_sharded(what, out, mesh, ref.fused_dsi, dm.depth_indices)
        progs = sharded_programs_phase(dev, "(a)", workload, mesh, tables, spec, runs)
    finally:
        sharded.clear_programs()
        meshmod.shutdown_distributed()
    _, seconds = median_seconds(lambda: run_chunk(workload, spec), runs)
    log(f"  process_1 + get_depth_map on the same chunk: median {np.median(seconds):.6f} s; "
        f"{smi}")
    res = {"a": dict(backend=backend, launches=launches, seconds=median, programs=progs,
                     **stats)}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as out_dir:
        t0 = time.perf_counter()
        meshmod.spawn_ranks(_dist_rank, 2, (out_dir, str(dev), rank_size or {}, spec, runs,
                                           needed), timeout=600)
        ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json"))) for r in range(2)]
    log(f"  (b) two ranks on one device over {ranks[0]['backend']}: {time.perf_counter() - t0:.1f} s "
        f"with start-up; seconds a chunk, rank 0: " + ", ".join(
            f"mesh {name} {ranks[0][name]['seconds']:.6f} (in turns: programs "
            f"{ranks[0][name]['programs']['programs_s']:.6f}, eager "
            f"{ranks[0][name]['programs']['eager_s']:.6f})" for name in ("2x1", "1x2")))
    res["b"] = ranks
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_ranks_") as workdir:
        res["c"] = cli_ranks_phase(dev, workdir)
    return res


# ---------------------------------------------------------------------------
# Phase 11: the host API and the user scripts
# ---------------------------------------------------------------------------

# vote_dsi against mapper.evaluate_dsi on the same packets: relative L1.
VOTE_DSI_REL = 1e-7
# The synthetic demo on the card against the same demo on the CPU: the
# same verdict, every count of its report (pixels, points) equal to the
# CPU's and every error within DEMO_REL of the CPU's, relative.  The CPU run is
# held to the JAX demo's report by tests/test_torch_scripts.py.
DEMO_SPECS = (HEADLINE_SPEC, "scatter")
DEMO_REL = 0.01
# Grid extras, the card against the CPU (tests/test_torch_grid_extras.py's
# tolerances against the JAX package): elementwise rtol / atol; statistics
# and local focus relative; 3D filters as a share of max |input|; Moran's
# I absolute; collapse_min's indices equal on this share of the pixels.
GRID_RTOL, GRID_ATOL = 1e-6, 1e-7
GRID_STAT_REL, GRID_FILTER_REL, GRID_MORAN_ABS = 1e-5, 1e-5, 1e-4
GRID_EQUAL = 0.999
# evaluate_dsec_torch.py against evaluate_sequence in process.
EVAL_ABS = 1e-12
# The butterfly probe: each spec's card-against-CPU relative L1 (phase 6's).
BF_CARD_VS_CPU = DEVICE_VS_CPU_L1
# evaluate_dsec's run: full_seq windows of the esim fixture, one fused
# depth map each (several frames to match and consolidate).
EVAL_WINDOWS = ["--full_seq", "--start_time_s=0", "--stop_time_s=1", "--duration=0.3",
                "--out_skip=0.25"]


def _rel_l1(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.double().cpu(), want.double().cpu()
    return float((g - w).abs().sum() / w.abs().sum().clamp(min=1e-30))


def vote_dsi_step(dev, workload, spec=HEADLINE_SPEC, needed=KERNELS_A_B) -> dict:
    """`voting.vote_dsi` on each camera's warped packets of the headline
    chunk (bucket-padded, at process_1's reference view) against
    `mapper.evaluate_dsi` on the same events; the kernels of `needed`
    launched by vote_dsi.  Returns {camera: relative L1}."""
    from dvs_mcemvs_torch import mapper as mappermod, pipeline
    from dvs_mcemvs_torch.ops import voting

    mappers, events, trajs, _ = workload
    T_rv_w = pipeline.place_reference_view(trajs[0], 0.5)
    out = {}
    for c, (m, ev, trj) in enumerate(zip(mappers, events, trajs)):
        packets, _, _ = mappermod.warp_chunk(m, ev, trj, T_rv_w, PACKET, "device", "bucket")
        zero_counts()
        t0 = time.perf_counter()
        got = voting.vote_dsi(packets, m.depth_vec.depths(), m.vcam, backend=spec)
        _sync(dev)
        seconds = time.perf_counter() - t0
        counts = read_counts()
        launches = {n: counts[n] for n in KERNELS_A_B}
        want = mappermod.evaluate_dsi(m, ev, trj, T_rv_w, PACKET, backend=spec, pad="bucket")
        rel = _rel_l1(got, want)
        log(f"  (a) vote_dsi camera{c} {spec}: {seconds:.3f} s, launches {launches}, "
            f"relative L1 against evaluate_dsi {rel:.3g}")
        if tuple(got.shape) != m.dsi_shape or rel > VOTE_DSI_REL:
            raise AssertionError(f"vote_dsi camera{c}: shape {tuple(got.shape)}, L1 {rel}")
        _check_launched(f"vote_dsi camera{c}", launches, needed)
        out[f"camera{c}"] = rel
    return out


def _run_demo(argv) -> tuple:
    """scripts/synthetic_demo_torch.py's main(argv) in this process:
    (exit code, report, seconds)."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = script("synthetic_demo_torch").main(argv)
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    report = json.loads(next(ln for ln in lines if ln.startswith("{")))
    if lines[-1] != ("PASS" if rc == 0 else "FAIL"):
        raise AssertionError(f"demo: exit {rc} but verdict {lines[-1]!r}")
    return rc, report, seconds


def demo_step(dev, specs=DEMO_SPECS, needed=KERNELS_A_B) -> dict:
    """The synthetic demo on the card under each spec (the hist specs must
    launch the kernels of `needed`), against the demo on the CPU: the same
    verdict, the same counts and every error within DEMO_REL.  The exact
    scatter must PASS.  Returns {spec: (exit code, report, seconds)}."""
    out = {}
    for spec in specs:
        zero_counts()
        rc, report, seconds = _run_demo(["--backend", spec,
                                         "--device", "cuda" if dev.type == "cuda" else "cpu"])
        counts = read_counts()
        launches = {n: counts[n] for n in KERNELS_A_B}
        cpu_rc, cpu_report, cpu_seconds = _run_demo(["--backend", spec, "--device", "cpu"])
        log(f"  (b) demo {spec}: {'PASS' if rc == 0 else 'FAIL'} in {seconds:.3f} s, "
            f"launches {launches}: {json.dumps(report)}")
        log(f"      the CPU: {'PASS' if cpu_rc == 0 else 'FAIL'} in {cpu_seconds:.3f} s: "
            f"{json.dumps(cpu_report)}")
        off = [k for k, v in cpu_report.items()
               if (isinstance(v, int) and report[k] != v)
               or (isinstance(v, float) and not abs(report[k] - v) <= DEMO_REL * abs(v))]
        if rc != cpu_rc or off:
            raise AssertionError(f"demo {spec}: the card disagrees with the CPU on {off}")
        if spec == "scatter" and rc != 0:
            raise AssertionError("demo scatter: FAIL")
        if spec.startswith("hist"):
            _check_launched(f"demo {spec}", launches, needed)
        out[spec] = (rc, report, seconds)
    return out


def _grid_checks():
    """(name, call on (fused, camera0, camera1), kind) of every grid extra."""
    from dvs_mcemvs_torch.ops import grid

    def two(name, **kw):
        return lambda g, a, b: getattr(grid, name)(a, b, **kw)

    def one(name, *args):
        return lambda g, a, b: getattr(grid, name)(g, *args)

    return [
        ("fuse_add", two("fuse_add"), "elementwise"),
        ("fuse_subtract", two("fuse_subtract"), "elementwise"),
        ("fuse_ratio", two("fuse_ratio"), "elementwise"),
        ("fuse_quadratic_mean", two("fuse_quadratic_mean"), "elementwise"),
        ("fuse_cubic_mean", two("fuse_cubic_mean"), "elementwise"),
        ("add_inverse", two("add_inverse"), "elementwise"),
        ("collapse_min", one("collapse_min"), "collapse"),
        ("mean_square", one("mean_square"), "stat"),
        ("min_max", one("min_max"), "stat"),
        ("mean_std", one("mean_std"), "stat"),
        ("hm_local_focus-0", two("fuse_harmonic_mean_of_local_focus", focus_method=0), "focus"),
        ("hm_local_focus-1", two("fuse_harmonic_mean_of_local_focus", focus_method=1), "focus"),
        ("laplacian3d", one("laplacian3d"), "filter"),
        ("diffuse-sigma1", one("diffuse", 1.0), "filter"),
        ("gaussian_blur_3d-sigma1", one("gaussian_blur_3d", 1.0), "filter"),
        ("moran_index-sigma1", one("moran_index_gaussian_weights", 1.0), "moran"),
    ]


def grid_extras_step(dev, fused_cpu, cams_cpu) -> dict:
    """Every grid extra on the headline chunk's fused DSI (one-grid ops) or
    its two camera DSIs (two-grid ops), on the card against the CPU, with
    the tolerances above; seconds and peak device memory each.  Returns
    {name: (seconds, error)}."""
    on_dev = [t.to(dev) for t in (fused_cpu, *cams_cpu)]
    scale = float(fused_cpu.abs().max())
    out = {}
    for name, fn, kind in _grid_checks():
        _sync(dev)
        _reset_peak(dev)
        t0 = time.perf_counter()
        got = fn(*on_dev)
        _sync(dev)
        seconds = time.perf_counter() - t0
        peak = _peak(dev)
        want = fn(fused_cpu, *cams_cpu)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        got = [g.cpu().double() for g in got]
        want = [w.double() for w in want]
        if kind == "elementwise":
            g, w = got[0], want[0]
            err = float((g - w).abs().max())
            ok = bool(((g - w).abs() <= GRID_ATOL + GRID_RTOL * w.abs()).all())
        elif kind == "collapse":
            err = float((got[1] == want[1]).double().mean())
            ok = err >= GRID_EQUAL and bool((got[0] == want[0]).all())
        elif kind in ("stat", "focus"):
            err = max(float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
                      for g, w in zip(got, want))
            ok = err <= GRID_STAT_REL
        elif kind == "filter":
            err = float((got[0] - want[0]).abs().max()) / scale
            ok = err <= GRID_FILTER_REL
        else:
            err = abs(float(got[0]) - float(want[0]))
            ok = err <= GRID_MORAN_ABS
        log(f"  (c) {name}: {seconds:.4f} s on the card, peak device memory {peak}; "
            f"{'equal indices' if kind == 'collapse' else 'error'} {err:.3g}"
            + (f" (I = {float(got[0]):.6f})" if kind == "moran" else ""))
        if not ok:
            raise AssertionError(f"grid extra {name}: the card disagrees with the CPU ({err})")
        out[name] = (seconds, err)
    return out


def evaluate_dsec_step(dev, workdir) -> dict:
    """The port's CLI (process_1 over EVAL_WINDOWS) on the esim fixture,
    then scripts/evaluate_dsec_torch.py by subprocess on its fused
    depth-point files against per-frame ground truth from
    `synthetic.ground_truth_depth`; its JSON must equal
    `eval.dsec.evaluate_sequence` in process to EVAL_ABS, over every depth
    file, and there must be more than one.  Returns the script's report."""
    from dvs_mcemvs_torch import cli
    from dvs_mcemvs_torch.eval import dsec
    from dvs_mcemvs_torch.ops.camera import virtual_camera
    from dvs_mcemvs_torch.utils import synthetic

    rig = synthetic.esim_like_rig(travel=0.4)
    paths = synthetic.write_fixture(os.path.join(workdir, "data"), rig=rig)
    run_dir = os.path.join(workdir, "run")
    flagfile = os.path.join(HERE, "configs", "synthetic", "esim_stereo.conf")
    rc = cli.main([f"--flagfile={flagfile}", f"--bag_filename_left={paths['events0']}",
                   f"--bag_filename_right={paths['events1']}",
                   f"--bag_filename_pose={paths['poses']}",
                   f"--platform={'cuda' if dev.type == 'cuda' else 'cpu'}",
                   f"--out_path={run_dir}/", "--process_method=1", *EVAL_WINDOWS,
                   "--nosave_pointcloud"])
    if rc != 0:
        raise AssertionError(f"evaluate_dsec: the CLI exited {rc}")
    cam = rig.cam
    vcam = virtual_camera(cam.width, cam.height, 0.0, cam)
    shape = (cam.height, cam.width)
    evaluator = script("evaluate_dsec_torch")
    rig_eval = dsec.DsecEvalRig(Q=np.eye(4), T_rect0_0=np.eye(4),
                                K_target=np.array([[cam.fx, 0, cam.cx], [0, cam.fx, cam.cy],
                                                   [0, 0, 1.0]]), baseline=rig.baseline)
    frames = evaluator.find_run_frames(run_dir, "fused")
    gt_dir = os.path.join(workdir, "gt")
    os.makedirs(gt_dir)
    est_maps, gt_maps = [], []
    for k, (t, path) in enumerate(frames):
        pts = np.atleast_2d(np.loadtxt(path)).reshape(-1, 3)
        xs, ys = pts[:, 0].astype(int), pts[:, 1].astype(int)
        gt = np.zeros(shape)
        gt[ys, xs] = synthetic.ground_truth_depth(
            rig, vcam, float(rig.camera_position(t)[0]), xs, ys, pts[:, 2])
        np.save(os.path.join(gt_dir, f"{k:06d}.npy"), gt)
        est_maps.append(dsec.load_depth_points(path, shape))
        gt_maps.append(np.ma.array(gt, mask=(gt < 0.05)))
    ts_file = os.path.join(workdir, "ts.txt")
    np.savetxt(ts_file, np.array([t * 1e6 for t, _ in frames]))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "scripts", "evaluate_dsec_torch.py"),
         "--run_dir", run_dir, "--suffix", "fused", "--gt_timestamps", ts_file,
         "--gt_depth_npy_dir", gt_dir, "--width", str(cam.width),
         "--height", str(cam.height), "--fx", str(cam.fx), "--cx", str(cam.cx),
         "--cy", str(cam.cy), "--baseline", str(rig.baseline)],
        capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"evaluate_dsec_torch.py: {proc.stderr[-2000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    want = dsec.evaluate_sequence(est_maps, gt_maps, rig_eval)
    want_flat = {"mean_err": float(want["mean_err"]),
                 "median_err": float(want["median_err"]),
                 **{k: float(v) for k, v in want["metrics"].as_dict().items()}}
    off = {k: (report[k], v) for k, v in want_flat.items()
           if not abs(report[k] - v) <= EVAL_ABS}
    err = max(abs(report[k] - v) for k, v in want_flat.items())
    log(f"  (d) evaluate_dsec_torch.py --suffix fused: {seconds:.2f} s, "
        f"{report['frames_evaluated']} of {len(frames)} frames (t = "
        f"{', '.join(f'{t:.3f}' for t in report['times'])} s), mean_err "
        f"{report['mean_err']:.6f} m, median_err {report['median_err']:.6f} m; "
        f"largest difference from evaluate_sequence {err:.3g}")
    if off or len(frames) < 2 or report["frames_evaluated"] != len(frames):
        raise AssertionError(f"evaluate_dsec: {len(frames)} depth files, "
                             f"{report['frames_evaluated']} evaluated, differs on {off}")
    return report


def golden_probe_step(dev, cfg_name="BENCH16", specs=None, needed=KERNELS_A_B) -> list:
    """scripts/golden_device_probe_torch.py's specs scored on the fixture
    (reported, not gated: phase 5 gates the literal spec); every spec must
    run and the kernels of `needed` launch."""
    mod = script("golden_device_probe_torch")
    zero_counts()
    rows = mod.probe(specs or mod.DEFAULT, cfg_name, dev)
    counts = read_counts()
    for row in rows:
        if "error" in row:
            raise AssertionError(f"golden probe {row['spec']}: {row['error']}")
        log(f"  (e) golden probe {cfg_name} {row['spec']}: within1 {row['within1']:.4f}, "
            f"within2 {row['within2']:.4f}, camera mass off by "
            f"{', '.join(f'{m:.4f}' for m in row['cam_mass_rel'])}, {row['seconds']:.2f} s")
    _check_launched("golden probe", {n: counts[n] for n in KERNELS_A_B}, needed)
    return rows


def bf_probe_step(dev, cfg_name="FULL", n_events=None) -> dict:
    """scripts/bf_divergence_probe_torch.py: the butterfly and the flat
    merge on the card and on the CPU; each spec's card-against-CPU
    relative L1 below BF_CARD_VS_CPU."""
    mod = script("bf_divergence_probe_torch")
    n_events = n_events or mod.N_EV
    t0 = time.perf_counter()
    card = mod.run(dev, cfg_name, n_events)
    t1 = time.perf_counter()
    cpu = mod.run(torch.device("cpu"), cfg_name, n_events)
    t2 = time.perf_counter()
    out = {tag: mod.rel_l1(card[tag], cpu[tag]) for tag in mod.SPECS}
    out.update({f"bf_vs_flat_{name}": mod.rel_l1(src["bf"], src["flat"])
                for name, src in (("card", card), ("cpu", cpu))})
    log(f"  (f) bf probe ({cfg_name}, {n_events} events a camera; card {t1 - t0:.2f} s, "
        f"cpu {t2 - t1:.2f} s): " + ", ".join(f"{k} {v:.3g}" for k, v in out.items()))
    bad = [tag for tag in mod.SPECS if not out[tag] < BF_CARD_VS_CPU]
    if bad:
        raise AssertionError(f"bf probe: the card disagrees with the CPU under {bad}: {out}")
    return out


def host_api_phase(dev, workload, fused_cpu, cams_cpu, smi="") -> dict:
    """Phase 11's steps (a)-(f), each logging its seconds."""
    def evaluate():
        with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as workdir:
            return evaluate_dsec_step(dev, workdir)

    steps = {"a": lambda: vote_dsi_step(dev, workload),
             "b": lambda: demo_step(dev),
             "c": lambda: grid_extras_step(dev, fused_cpu, cams_cpu),
             "d": evaluate,
             "e": lambda: golden_probe_step(dev),
             "f": lambda: bf_probe_step(dev)}
    res = {}
    for key, fn in steps.items():
        t0 = time.perf_counter()
        res[key] = fn()
        log(f"  ({key}) in {time.perf_counter() - t0:.1f} s" + (f"; {smi}" if smi else ""))
    return res


# ---------------------------------------------------------------------------
# Phase 12: the chunk's programs (CUDA graphs) against mapper.eager()
# ---------------------------------------------------------------------------

# Every spec the chunk runs under, each captured against eager: the headline
# spec, phase 6's forms and the exact scatter.  `sort` takes float64 run
# totals (relative L1 limit); i8 sums integers in kernel A and runs kernel B
# in a fixed order (equal); the rest are held to phase 3's tolerance (kernel
# A's f32 shared-memory sums and the scatter's `index_add_` change order
# from run to run).  Depth indices equal on PROGRAM_EQUAL of the pixels.
PROGRAM_SPECS = (HEADLINE_SPEC, *SPEC_FORMS, "scatter")
PROGRAM_SORT_L1, PROGRAM_EQUAL = 1e-6, 0.999
PROGRAM_RUNS = 10


def chunk_graphs(n_cams: int) -> int:
    """Graph launches of a process_1 + get_depth_map chunk on programs: the
    reference view's pose, each camera's warp and vote, the fusion, the
    extraction."""
    return 1 + n_cams + 1 + 1


def _gib(n: int) -> float:
    return n / 2**30


def program_summary() -> dict:
    """The chunk programs held, the process's graph captures and replays so
    far (one graph a chunk program), and the capture seconds of each
    program held."""
    from dvs_mcemvs_torch import graphs, mapper as mappermod

    progs = mappermod.programs()
    return dict(programs=len(progs), captures=graphs.Graph.captures_total,
                replays=graphs.Graph.replays_total,
                capture_s=[round(p.capture_s, 3) for p in progs])


def program_vs_eager(dev, workload, spec, needed=KERNELS_A_B) -> dict:
    """The chunk under `spec` inside `mapper.eager()`, then on its programs
    (the first run captures them unless they are held, the next replays
    them): each camera's DSI against eager's, the fused depth indices, the
    launch counts of a replayed run against the eager run's, and peak device
    memory of each run.  Raises beyond the limits above."""
    from dvs_mcemvs_torch import mapper as mappermod

    def counted(fn):
        _reset_peak(dev)
        before = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        zero_counts()
        out = fn()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        return out, {n: counts[n] for n in KERNELS_A_B}, (_gib(before), _gib(peak))

    def eager():
        with mappermod.eager():
            return run_chunk(workload, spec)

    (want, dm_want), eager_counts, mem_eager = counted(eager)
    _, _, mem_capture = counted(lambda: run_chunk(workload, spec))
    replays = program_summary()["replays"]
    (got, dm_got), counts, mem_replay = counted(lambda: run_chunk(workload, spec))
    n_cams = len(workload[1])
    replayed = program_summary()["replays"] - replays
    if replayed != chunk_graphs(n_cams):
        raise AssertionError(f"{spec}: {replayed} programs replayed, not "
                             f"{chunk_graphs(n_cams)}")
    if counts != eager_counts:
        raise AssertionError(f"{spec}: a replay counts {counts}, eager {eager_counts}")
    _check_launched(f"{spec} on programs", counts, needed)
    errs = []
    for c in range(n_cams):
        g, w = got.dsis[f"camera{c}"], want.dsis[f"camera{c}"]
        what = f"{spec} camera{c} program vs eager"
        if spec == I8_SPEC:
            errs.append(compare_exact(what, g, w))
        elif spec == "sort":
            l1 = _rel_l1(g, w)
            log(f"  {what}: relative L1 {l1:.3g} (limit {PROGRAM_SORT_L1:g})")
            if not l1 <= PROGRAM_SORT_L1:
                raise AssertionError(f"{what}: relative L1 {l1}")
            errs.append(l1)
        else:
            errs.append(compare(what, g, w))
    equal = float((dm_got.depth_indices == dm_want.depth_indices).double().mean())
    log(f"  {spec}: depth indices equal on {equal:.6f} of the pixels (limit "
        f"{PROGRAM_EQUAL:g}); launches {counts} (eager {eager_counts}); device memory "
        f"held before / peak, GiB: eager {mem_eager[0]:.3f} / {mem_eager[1]:.3f}, "
        f"capturing {mem_capture[0]:.3f} / {mem_capture[1]:.3f}, replayed "
        f"{mem_replay[0]:.3f} / {mem_replay[1]:.3f}")
    if equal < PROGRAM_EQUAL:
        raise AssertionError(f"{spec}: depth indices of the programs differ from eager")
    return dict(err=max(errs), equal=equal, launches=counts, mem_eager=mem_eager,
                mem_capture=mem_capture, mem_replay=mem_replay)


def fresh_output_step(dev, workload, spec=HEADLINE_SPEC) -> None:
    """A DSI that a program returned stays as it was after the program's
    next replay, on other events."""
    from dvs_mcemvs_torch import mapper as mappermod, pipeline

    mappers, events, trajs, _ = workload
    T_rv_w = pipeline.place_reference_view(trajs[0], 0.5)
    kw = dict(packet_size=PACKET, backend=spec, pad="bucket")
    first = mappermod.evaluate_dsi(mappers[0], events[0], trajs[0], T_rv_w, **kw)
    kept = first.clone()
    replays = program_summary()["replays"]
    second = mappermod.evaluate_dsi(mappers[0], events[1], trajs[0], T_rv_w, **kw)
    _sync(dev)
    same, differ = bool(torch.equal(first, kept)), not bool(torch.equal(first, second))
    replayed = program_summary()["replays"] - replays
    log(f"  a returned DSI after the next replay of its program (other events): unchanged "
        f"{same}, the new DSI differs {differ}; replays {replayed}")
    if not (same and differ and replayed == (dev.type == "cuda")):
        raise AssertionError("a program's output is not a fresh DSI")


def refused_weights_step(dev, workload, spec=I8_SPEC) -> str:
    """A chunk whose staged weights int8 binning refuses (one weight of 1.5)
    raises at its extraction, through the device fault flag; the next clean
    chunk does not.  Returns the message."""
    from dvs_mcemvs_torch import mapper as mappermod

    real = mappermod._stage_weights

    def refused(w, n):
        real(w, n)
        w[n // 2] = 1.5

    mappermod._stage_weights = refused
    try:
        run_chunk(workload, spec)
    except ValueError as e:
        message = str(e)
    else:
        raise AssertionError("a chunk of refused weights gave a depth map")
    finally:
        mappermod._stage_weights = real
    run_chunk(workload, spec)
    log(f"  refused weights under {spec}: raised {message!r}; the next chunk ran clean")
    return message


def program_timing_step(dev, workload, spec=HEADLINE_SPEC, runs=PROGRAM_RUNS) -> dict:
    """process_1 + get_depth_map on programs and eagerly, in turns after a
    warm-up of each; the profile of one chunk of each
    (scripts/profile_torch_chunk.py); the output copy's time."""
    from dvs_mcemvs_torch import mapper as mappermod

    def chunk(mode):
        with mappermod.eager() if mode == "eager" else contextlib.nullcontext():
            run_chunk(workload, spec)

    samples = {"programs": [], "eager": []}
    for mode in samples:
        chunk(mode)
    for i in range(runs):
        for mode in (("programs", "eager") if i % 2 == 0 else ("eager", "programs")):
            t0 = time.perf_counter()
            chunk(mode)
            samples[mode].append(time.perf_counter() - t0)
    out = {}
    n_ev = sum(e.num for e in workload[1])
    for mode, secs in samples.items():
        med = float(np.median(secs))
        out[mode] = med
        log(f"  {spec} chunk {mode} (median of {runs}, in turns): {med:.6f} s, "
            f"{n_ev / med / 1e6:.3f} Mev/s [{', '.join(f'{t:.6f}' for t in secs)}]")
    if dev.type == "cuda":
        prof = script("profile_torch_chunk")
        for mode in samples:
            res = prof.profile_chunk(workload, spec, mode == "eager")
            prof.report(res, f"  profiled {mode} chunk", top=8, log=log)
            out[f"{mode}_idle_share"] = res["idle_share"]
            out[f"{mode}_profile"] = res
        prog = [p for p in mappermod.programs() if p.body.backend == spec][-1]
        dsi = prog.graph.out
        copy_ms = cuda_graph_ms(lambda: dsi.clone())
        wm = work_model()
        log(f"  the output copy of one camera's DSI ({_gib(wm.nbytes(dsi)) * 1024:.1f} MiB): "
            f"{copy_ms:.4f} ms by graph; bound {wm.bound(2 * wm.nbytes(dsi), 0)['bound_ms']:.4f} "
            "ms")
        out["copy_ms"] = copy_ms
        out.update(program_call_parts(dev, workload, prog))
    return out


def program_call_parts(dev, workload, prog, runs=5) -> dict:
    """Where one camera's program call spends its time: the host's staging
    (events into a pinned buffer, copies queued; the card idle), and the
    replay on the card between CUDA events.  Medians of `runs`."""
    from dvs_mcemvs_torch import pipeline

    mappers, events, trajs, _ = workload
    T_rv_w = pipeline.place_reference_view(trajs[0], 0.5)
    stage_s, replay_ms = [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog._load(events[0], trajs[0], T_rv_w)
        stage_s.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        start.record()
        prog.graph.replay()
        end.record()
        end.synchronize()
        replay_ms.append(start.elapsed_time(end))
    parts = dict(stage_ms=1e3 * float(np.median(stage_s)),
                 replay_ms=float(np.median(replay_ms)))
    log(f"  one camera's program call, median of {runs}: host staging {parts['stage_ms']:.3f} ms "
        f"[{', '.join(f'{1e3 * t:.3f}' for t in stage_s)}], replay on the card "
        f"{parts['replay_ms']:.3f} ms [{', '.join(f'{t:.3f}' for t in replay_ms)}]")
    return parts


def programs_phase(dev, workload, specs=PROGRAM_SPECS, runs=PROGRAM_RUNS) -> dict:
    """Phase 12's steps; returns {spec: program_vs_eager's result, ...}."""
    from dvs_mcemvs_torch import mapper as mappermod

    out = {spec: program_vs_eager(dev, workload, spec, needed=SPEC_FORMS.get(
        spec, KERNELS_A_B if spec == HEADLINE_SPEC else ())) for spec in specs}
    fresh_output_step(dev, workload)
    out["refused"] = refused_weights_step(dev, workload)
    out["timing"] = program_timing_step(dev, workload, runs=runs)
    summary = program_summary()
    log(f"  programs held: {summary['programs']} (cache of {mappermod.PROGRAM_CACHE_SIZE}); "
        f"capture seconds each (least recently used first): {summary['capture_s']}")
    return out


# ---------------------------------------------------------------------------
# Phase 13: whole-chunk programs (the reference view, fusion, extraction,
# the temporal step) and events already on the card
# ---------------------------------------------------------------------------

# Specs of (a): the headline and its int8 form are equal to eager to the bit
# (the same kernels on the same inputs in the same order); `scatter`'s
# atomic `index_add_` order changes from run to run (phase 3's tolerance,
# indices equal on PROGRAM_EQUAL).  (b) extracts under every collapse method.
WHOLE_SPECS = (HEADLINE_SPEC, I8_SPEC, "scatter")
COLLAPSE_METHODS = (-1, 0, 1, 2, 3, 4)
MAP_NAMES = ("depth", "confidence", "mask", "depth_indices")


def _chunk_outputs(res, dm) -> dict:
    """A chunk's fused DSI and its four maps, by name."""
    return {"fused": res.fused_dsi, **{k: getattr(dm, k) for k in MAP_NAMES}}


def _graph_launches(fn):
    """fn()'s result and the graph launches it made (synchronised)."""
    from dvs_mcemvs_torch import graphs

    replays = graphs.Graph.replays_total
    out = fn()
    return out, graphs.Graph.replays_total - replays


def _expected_graphs(dev, n: int) -> int:
    return n if dev.type == "cuda" else 0


def _equal_outputs(what: str, got: dict, want: dict) -> float:
    """Every tensor of `got` equal to `want`'s to the bit; returns 0."""
    return max(compare_exact(f"{what} {k}", got[k], want[k]) for k in want)


def whole_chunk_vs_eager(dev, workload, spec) -> dict:
    """process_1 + get_depth_map under `spec` inside `mapper.eager()`, then
    on programs (captured unless held), then replayed: the fused DSI and
    the four maps equal to eager's to the bit under a hist spec; under
    `scatter` the fused DSI within phase 3's tolerance and the depth
    indices equal on PROGRAM_EQUAL of the pixels; a replayed chunk makes
    `chunk_graphs` graph launches.  Raises beyond these."""
    from dvs_mcemvs_torch import mapper as mappermod

    with mappermod.eager():
        want = _chunk_outputs(*run_chunk(workload, spec))
    run_chunk(workload, spec)
    got, replayed = _graph_launches(lambda: _chunk_outputs(*run_chunk(workload, spec)))
    what = f"{spec} whole chunk, programs vs eager:"
    expected = _expected_graphs(dev, chunk_graphs(len(workload[1])))
    if replayed != expected:
        raise AssertionError(f"{what} {replayed} graph launches, not {expected}")
    if spec.startswith("hist"):
        err = _equal_outputs(what, got, want)
        equal = 1.0
    else:
        err = compare(f"{what} fused", got["fused"], want["fused"])
        equal = float((got["depth_indices"] == want["depth_indices"]).double().mean())
        if equal < PROGRAM_EQUAL:
            raise AssertionError(f"{what} depth indices equal on {equal}")
    log(f"  {what} graph launches a chunk {replayed} (the reference view, 2 cameras, the "
        f"fusion, the extraction); depth indices equal on {equal:.6f}")
    return dict(err=err, equal=equal, graphs=replayed)


def whole_chunk_fresh_step(dev, workload, spec=HEADLINE_SPEC) -> None:
    """A chunk's fused DSI and maps, returned by the programs, stay as they
    were after the next chunk (other events) replays them."""
    mappers, events, trajs, rig = workload
    first = _chunk_outputs(*run_chunk(workload, spec))
    kept = {k: v.clone() for k, v in first.items()}
    second = _chunk_outputs(*run_chunk((mappers, events[::-1], trajs, rig), spec))
    same = all(bool(torch.equal(first[k], kept[k])) for k in kept)
    differ = not bool(torch.equal(first["fused"], second["fused"]))
    log(f"  a chunk's fused DSI and maps after the next chunk's replays: unchanged {same}; "
        f"the next chunk's differ {differ}")
    if not (same and differ):
        raise AssertionError("a whole-chunk program's result is not fresh")


def whole_chunk_memory(dev, workload, spec=HEADLINE_SPEC) -> dict:
    """Every program of the chunk captured afresh (the programs held are
    closed first): device memory held before and at the peak of each
    capture, GiB.  Returns {program: (before, peak)}."""
    from dvs_mcemvs_torch import mapper as mappermod, pipeline
    from dvs_mcemvs_torch.ops import extract

    mappers, events, trajs, _ = workload
    mappermod.clear_programs()
    pipeline.clear_programs()
    out = {}

    def peak(name, fn):
        _sync(dev)
        _reset_peak(dev)
        before = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        res = fn()
        _sync(dev)
        after = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        out[name] = (_gib(before), _gib(after))
        return res

    T_rv_w = peak("reference view", lambda: pipeline.place_reference_view(trajs[0], 0.5))
    kw = dict(packet_size=PACKET, backend=spec, pad="bucket")
    dsis = [peak(f"camera{c}", lambda c=c: mappermod.evaluate_dsi(
        mappers[c], events[c], trajs[c], T_rv_w, **kw)) for c in range(len(events))]
    fused = peak("fusion", lambda: pipeline.fuse_dsis(dsis, 2))
    peak("extraction", lambda: mappermod.get_depth_map(mappers[0], fused,
                                                       extract.DepthMapOptions()))
    log("  device memory held before / at the peak of each program's capture, GiB: "
        + "; ".join(f"{k} {b:.3f} / {p:.3f}" for k, (b, p) in out.items()))
    return out


def extraction_programs_step(dev, workload, fused, spec=HEADLINE_SPEC, dim_z=DEEP_Z) -> dict:
    """The extraction program against `mapper.eager()`, equal to the bit,
    under every collapse method on the headline chunk's fused DSI, and on a
    `dim_z`-plane chunk's (more than 256: the gather + sort median).  Each
    replay is one graph launch.  Returns {case: seconds of the replay}."""
    from dvs_mcemvs_torch import mapper as mappermod, pipeline
    from dvs_mcemvs_torch.ops import extract

    mappers, events, trajs, rig = workload
    dv = mappers[0].depth_vec
    deep = mappermod.make_mapper(rig.cam, mappermod.DsiShape(
        dim_z=dim_z, min_depth=dv.min_depth, max_depth=dv.max_depth))
    vopts = pipeline.VotingOptions(packet_size=PACKET, backend=spec, pad_policy="bucket")
    deep_fused = pipeline.process_1([deep, deep], events, trajs, 0.5, stereo_fusion=2,
                                    vopts=vopts).fused_dsi
    cases = [(f"collapse_method {m}", mappers[0], fused, m) for m in COLLAPSE_METHODS]
    cases.append((f"{dim_z} planes", deep, deep_fused, -1))
    out = {}
    for what, mapper, dsi, method in cases:
        opts = extract.DepthMapOptions(collapse_method=method)
        with mappermod.eager():
            want = mappermod.get_depth_map(mapper, dsi, opts)._asdict()
        mappermod.get_depth_map(mapper, dsi, opts)
        t0 = time.perf_counter()
        got, replayed = _graph_launches(
            lambda: mappermod.get_depth_map(mapper, dsi, opts)._asdict())
        _sync(dev)
        out[what] = time.perf_counter() - t0
        if replayed != _expected_graphs(dev, 1):
            raise AssertionError(f"extraction {what}: {replayed} graph launches")
        _equal_outputs(f"extraction program vs eager, {what}:",
                       {k: got[k] for k in MAP_NAMES}, {k: want[k] for k in MAP_NAMES})
    log("  extraction replays, s (one graph launch each, synchronised): "
        + ", ".join(f"{k} {v:.6f}" for k, v in out.items()))
    return out


def temporal_programs_step(dev, workload, spec=HEADLINE_SPEC, intervals=N_INTERVALS,
                           runs=3) -> dict:
    """process_2 (AM and HM, `intervals` sub-intervals) on programs against
    `mapper.eager()`: every output DSI equal to the bit; a replayed call's
    graph launches (the reference view, each sub-interval's cameras and
    temporal step, the finalisation); seconds of both in turns (median of
    `runs` after a warm-up).  Returns {method: {...}}."""
    from dvs_mcemvs_torch import mapper as mappermod, pipeline

    mappers, events, trajs, _ = workload
    vopts = pipeline.VotingOptions(packet_size=PACKET, backend=spec, pad_policy="bucket")
    n_cams = len(events)
    out = {}
    for fusion, name in ((pipeline.TEMPORAL_AM, "AM"), (pipeline.TEMPORAL_HM, "HM")):
        def call(mode):
            with mappermod.eager() if mode == "eager" else contextlib.nullcontext():
                res = pipeline.process_2(mappers, events, trajs, 0.5, stereo_fusion=2,
                                         temporal_fusion=fusion, num_intervals=intervals,
                                         vopts=vopts)
                _sync(dev)
            return {"fused": res.fused_dsi, **res.dsis}

        want = call("eager")
        _reset_peak(dev)
        call("programs")
        got, replayed = _graph_launches(lambda: call("programs"))
        expected = _expected_graphs(dev, 1 + intervals * (n_cams + 1) + 1)
        what = f"process_2 {name} ({intervals} sub-intervals, {spec}), programs vs eager:"
        if replayed != expected:
            raise AssertionError(f"{what} {replayed} graph launches, not {expected}")
        _equal_outputs(what, got, want)
        del got, want
        samples = {"programs": [], "eager": []}
        for i in range(runs):
            for mode in (("programs", "eager") if i % 2 == 0 else ("eager", "programs")):
                t0 = time.perf_counter()
                call(mode)
                samples[mode].append(time.perf_counter() - t0)
        med = {mode: float(np.median(v)) for mode, v in samples.items()}
        text = {mode: f"{med[mode]:.6f} [{', '.join(f'{t:.6f}' for t in v)}]"
                for mode, v in samples.items()}
        log(f"  {what} {replayed} graph launches a call; seconds (median of {runs}, in "
            f"turns) programs {text['programs']}, eager {text['eager']}; peak device memory "
            f"{_peak(dev)}")
        out[name] = dict(graphs=replayed, **med)
    return out


def device_events_step(dev, workload, spec=HEADLINE_SPEC, runs=5) -> dict:
    """The headline chunk's events as tensors on the card against the same
    events as host arrays (pad="bucket"): each camera's DSI equal to the
    bit on programs and eagerly; a time window by binary search on the card
    equal to the host's; one camera's staging into its program (host: the
    pinned buffers and their copies, host clock; card: device-to-device
    copies, host clock and device time between CUDA events); chunk seconds
    of both in turns (median of `runs`)."""
    from dvs_mcemvs_torch import mapper as mappermod, pipeline
    from dvs_mcemvs_torch.mapper import Events

    mappers, events, trajs, rig = workload
    on_card = [Events(*(torch.as_tensor(a, device=dev) for a in (e.x, e.y, e.t)))
               for e in events]
    T_rv_w = pipeline.place_reference_view(trajs[0], 0.5)
    kw = dict(packet_size=PACKET, backend=spec, pad="bucket")
    for mode in ("programs", "eager"):
        with mappermod.eager() if mode == "eager" else contextlib.nullcontext():
            for c in range(len(events)):
                want = mappermod.evaluate_dsi(mappers[c], events[c], trajs[c], T_rv_w, **kw)
                got = mappermod.evaluate_dsi(mappers[c], on_card[c], trajs[c], T_rv_w, **kw)
                compare_exact(f"events on the card vs on the host, camera{c}, {mode}", got,
                              want)
    t = events[0].t
    t0, t1 = float(t[len(t) // 5]), float(t[len(t) // 2])
    n_host, n_card = events[0].time_window(t0, t1).num, on_card[0].time_window(t0, t1).num
    log(f"  time_window [{t0:.6f}, {t1:.6f}]: host {n_host} events, card {n_card}")
    if n_host != n_card:
        raise AssertionError("a time window on the card differs from the host's")
    out = {}
    if dev.type == "cuda":
        key = mappermod.program_key(mappers[0], events[0].num, trajs[0], PACKET, spec, 8,
                                    "device", "bucket")
        prog = mappermod._PROGRAMS.get(key)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        parts = {"host": [], "card": [], "card_device": []}
        for _ in range(runs):
            for where, ev in (("host", events[0]), ("card", on_card[0])):
                torch.cuda.synchronize()
                start.record()
                t_0 = time.perf_counter()
                prog._load(ev, trajs[0], T_rv_w)
                parts[where].append(1e3 * (time.perf_counter() - t_0))
                end.record()
                end.synchronize()
                if where == "card":
                    parts["card_device"].append(start.elapsed_time(end))
        out = {k: float(np.median(v)) for k, v in parts.items()}
        log(f"  one camera's staging into its program, median of {runs}: host events "
            f"{out['host']:.3f} ms of host time; events on the card {out['card']:.3f} ms of "
            f"host time, {out['card_device']:.3f} ms of device copies")
    samples = {"host": [], "card": []}
    card_workload = (mappers, on_card, trajs, rig)
    for wl in (workload, card_workload):
        run_chunk(wl, spec)
    for i in range(runs):
        for where in (("host", "card") if i % 2 == 0 else ("card", "host")):
            t_0 = time.perf_counter()
            run_chunk(workload if where == "host" else card_workload, spec)
            samples[where].append(time.perf_counter() - t_0)
    for where, v in samples.items():
        out[f"chunk_{where}_s"] = float(np.median(v))
    log(f"  chunk on programs (median of {runs}, in turns): events on the host "
        f"{out['chunk_host_s']:.6f} s, on the card {out['chunk_card_s']:.6f} s")
    return out


def stage_reports_step(dev, workload, kernels: dict, spec=HEADLINE_SPEC) -> dict:
    """scripts/roofline_torch.py and scripts/profile_torch_chunk.py (the
    vote and extraction splits, a process_2 AM call) on the headline chunk,
    each printing one JSON line; the roofline's kernel stages must carry
    phase 3's bounds (`kernels`: kernel_phase's rows), the same work model
    on the same shapes: binning and the sweep one call each, the merge two
    levels of phase 3's one."""
    report = script("roofline_torch").run(workload, spec, log=log)
    print(json.dumps({"roofline": report}), flush=True)
    pairs = (("binning", "bin_events", 1), ("merge", "banded_resample_sum", 2),
             ("sweep", "banded_resample_fanin", 1))
    for stage, row, calls in pairs:
        got, want = report["stages"][stage]["bound_ms"], calls * kernels[row]["bound_ms"]
        log(f"  roofline {stage} bound {got:.6f} ms; phase 3's {row} x {calls} {want:.6f} ms")
        if abs(got - want) > 1e-9 * want:
            raise AssertionError(f"the roofline's {stage} bound is not phase 3's")
    prof = script("profile_torch_chunk").run(workload, stages=("vote", "extract"), process=2,
                                             spec=spec, log=log)
    # (the kernel lists of the process_2 profiles are logged above)
    print(json.dumps({"stage_profile": {split: {k: v for k, v in rows.items() if k != "kernels"}
                                        for split, rows in prof.items()}}), flush=True)
    return dict(roofline=report, profile=prof)


def whole_chunk_phase(dev, workload, kernels: dict, timing: dict, specs=WHOLE_SPECS,
                      spec=HEADLINE_SPEC, dim_z=DEEP_Z) -> dict:
    """Phase 13's steps: (a) the whole chunk on programs against eager under
    WHOLE_SPECS, a fresh result, each program's memory, the launch calls of
    phase 12's profiled chunks (`timing`: program_timing_step's); (b) the
    extraction program under every collapse method and at DEEP_Z planes; (c)
    process_2 AM and HM; (d) events on the card; (e) the roofline and the
    stage profiler (`kernels`: kernel_phase's rows)."""
    out = {"memory": whole_chunk_memory(dev, workload, spec)}
    for s in specs:
        out[s] = whole_chunk_vs_eager(dev, workload, s)
    whole_chunk_fresh_step(dev, workload, spec)
    if dev.type == "cuda":
        launches = {mode: timing[f"{mode}_profile"]["launches"] for mode in ("programs", "eager")}
        log(f"  profiled chunk (phase 12): launch calls on programs {launches['programs']}, "
            f"eager {launches['eager']}; idle share {timing['programs_idle_share']:.3f} / "
            f"{timing['eager_idle_share']:.3f}; seconds {timing['programs']:.6f} / "
            f"{timing['eager']:.6f}")
        if launches["programs"] != chunk_graphs(len(workload[1])):
            raise AssertionError(f"a chunk on programs made {launches['programs']} launch "
                                 f"calls, not its {chunk_graphs(len(workload[1]))} graphs")
        out["launches"] = launches
    fused = run_chunk(workload, spec)[0].fused_dsi
    out["extraction"] = extraction_programs_step(dev, workload, fused, spec, dim_z)
    del fused
    out["temporal"] = temporal_programs_step(dev, workload, spec)
    out["events"] = device_events_step(dev, workload, spec)
    if dev.type == "cuda":
        out.update(stage_reports_step(dev, workload, kernels, spec))
    return out


# ---------------------------------------------------------------------------
# Phase 14: bench_torch.py, the port's benchmark
# ---------------------------------------------------------------------------

# bench_torch.time_step's seconds a timed region here (its own default is
# 1.2), and the sustained loop's chunks (its default; 2 not timed).
BENCH_MIN_TIME = 0.3
BENCH_CHUNKS = 22
BENCH_STEPS = ("make_step", "make_full_chunk_step", "make_alg2_step")
BENCH_STAGES = ("voting", "alternatives", "full_chunk", "alg2", "full_seq_sustained", "golden")


def bench_module():
    """bench_torch.py, beside this script."""
    sys.path.insert(0, HERE)
    import bench_torch

    return bench_torch


def bench_step_vs_eager(dev, bt, workload, maker, spec, needed=KERNELS_A_B) -> dict:
    """bench_torch's step `maker` under `spec` inside `mapper.eager()`, then
    on its program (the first call captures it, the second replays): the
    replay's output equal to eager's to the bit, and the replay launching
    kernels A and B (counts from zero).  Returns the replay's launches."""
    from dvs_mcemvs_torch import mapper as mappermod

    mapper, ev, traj, T_rv_w = workload
    args = bt.device_args(*ev, dev)
    step = getattr(bt, maker)(mapper, traj, T_rv_w, spec, bt.PLANE_BLOCK)
    try:
        with mappermod.eager():
            want = step(*args)
        step(*args)
        zero_counts()
        got = step(*args)
        _sync(dev)
        counts = read_counts()
    finally:
        step.close()
    launches = {n: counts[n] for n in needed}
    compare_exact(f"bench {maker} ({spec}), program vs eager", got, want)
    log(f"  bench {maker}: a replay's launches {launches}")
    _check_launched(f"bench {maker}", launches, needed)
    return launches


def bench_phase(dev, roofline=None, min_time=BENCH_MIN_TIME, n_chunks=BENCH_CHUNKS,
                needed=KERNELS_A_B) -> dict:
    """bench_torch.py in this process: (a) each step's program against
    `mapper.eager()` (`bench_step_vs_eager`); (b) `bench_torch.run`, the
    stages of its main (`roofline`: phase 13's report, not taken again),
    its JSON line printed on a line of its own: no stage failed, kernels A
    and B launched in every stage, the sustained loop's chunks, events,
    store ingest and PNGs, the golden gate passed on the literal spec;
    (c) the sustained loop again inside `mapper.eager()`: every chunk's
    downlinked bytes equal to the programs' run.  Returns the line."""
    from dvs_mcemvs_torch import mapper as mappermod, pipeline

    mappermod.clear_programs()
    pipeline.clear_programs()
    bt = bench_module()
    spec = bt.headline_spec()
    if spec != HEADLINE_SPEC:
        raise AssertionError(f"bench_torch's spec {spec} is not the headline {HEADLINE_SPEC}")
    workload = bt.build_workload(dev)
    for maker in BENCH_STEPS:
        bench_step_vs_eager(dev, bt, workload, maker, spec, needed)
    del workload

    got = {}
    line, failed = bt.run(dev, min_time=min_time, n_chunks=n_chunks, roofline=roofline,
                          buffers=got)
    print(json.dumps(line), flush=True)
    if failed:
        raise AssertionError(f"bench_torch stages failed: {failed}")
    detail = line["detail"]
    for stage in BENCH_STAGES:
        _check_launched(f"bench stage {stage}", detail["launches"][stage], needed)
    sus = detail["full_seq_sustained"]
    expected = dict(chunks_timed=n_chunks - 2, events_per_chunk=2 * bt.N_EVENTS,
                    store_ingest=True, device_resident_events=True,
                    artifact_files=2 * n_chunks)
    found = {k: sus[k] for k in expected}
    log(f"  bench sustained: {found}; {sus['seconds_per_chunk']:.6f} s a chunk, a save "
        f"{sus['save_s_per_chunk']:.6f} s in a worker, final drain {sus['final_drain_s']:.6f} s")
    if found != expected:
        raise AssertionError(f"bench sustained: {found}, not {expected}")
    if not (detail["golden"]["pass"] and detail["golden"]["spec"] == HEADLINE_SPEC):
        raise AssertionError(f"bench golden gate: {detail['golden']}")

    want = {}
    with mappermod.eager():
        bt.full_seq_sustained(spec, bt.PLANE_BLOCK, n_chunks=n_chunks, device=dev,
                              buffers=want)
    if sorted(got) != sorted(want) or len(got) != n_chunks:
        raise AssertionError(f"bench sustained chunks: {sorted(got)}, eager {sorted(want)}")
    chunks = sorted(want)
    compare_exact(f"bench sustained: {n_chunks} chunks' downlinked bytes, program vs eager",
                  torch.from_numpy(np.stack([got[k] for k in chunks])),
                  torch.from_numpy(np.stack([want[k] for k in chunks])))
    return line


# ---------------------------------------------------------------------------
# Phase 15: the sharding-overhead protocol (scripts/scaling_bench_torch.py)
# ---------------------------------------------------------------------------

# The fields the port's report adds to a row of scripts/scaling_bench.py's.
SCALING_EXTRA = ("backend", "ranks")


def scaling_fields_match(rep: dict, ref: dict) -> list:
    """Where the field names of `rep` differ from those of `ref`
    (SCALING.json), a row of `rep` having SCALING_EXTRA besides."""
    diffs = []
    for part in (None, "workload", "target", "summary"):
        a = set(rep if part is None else rep[part])
        b = set(ref if part is None else ref[part])
        if a != b:
            diffs.append((part or "top level", sorted(a ^ b)))
    want = set(ref["results"][0]) | set(SCALING_EXTRA)
    for row in rep["results"]:
        if set(row) != want:
            diffs.append((f"row {row.get('mesh')}", sorted(set(row) ^ want)))
    return diffs


def scaling_phase(dev, smi="") -> dict:
    """Phase 15: scripts/scaling_bench_torch.py's protocol on this device at
    its workload (320x240x64, 262,144 events, `hist:g16,seg8`): every mesh
    on ranks sharing the device, timed as its main times them; the table,
    each row's share of rank 0's depth indices equal to the (1,1) row's
    (recorded, not gated), and the report.  Raises where a row is missing
    or not finite, where kernels A and B did not both run on the (1,1) row
    (on the card), or where the report's field names differ from
    SCALING.json's but for SCALING_EXTRA.  Returns rank 0's launches
    summed over the rows, and the report."""
    from dvs_mcemvs_torch.parallel import pick_mesh_shape

    sb = script("scaling_bench_torch")
    default_mesh = pick_mesh_shape(8, sb.DIM_Z, backend=sb.BACKEND)
    t0 = time.perf_counter()
    rows = sb.run(sb.MESHES, str(dev))
    seconds = time.perf_counter() - t0
    sb.check_rows(rows, sb.MESHES, str(dev))
    rep = sb.report(rows, default_mesh, smi or str(dev))
    log(f"  {len(rows)} meshes on {max(r['ranks'] for r in rows)} ranks sharing {dev}, "
        f"{sb.N_EVENTS} events, {sb.DIM_Z}x{sb.HEIGHT}x{sb.WIDTH}, {sb.BACKEND}, packet "
        f"{sb.PACKET}: {seconds:.1f} s with start-up")
    for row, res in zip(rows, rep["results"]):
        log(f"  mesh {tuple(res['mesh'])}: {res['ranks']} rank(s) over {res['backend']}, "
            f"{res['seconds_per_step']:.6f} s a step (min of {sb.RUNS} runs of {sb.STEPS}), "
            f"spread {res['run_spread_rel']:.3f}, overhead {res['overhead_vs_1dev']:+.4f}, "
            f"efficiency floor {res['projected_efficiency_floor']:.4f}"
            f"{' (shipped default)' if res['is_shipped_default'] else ''}; rank 0's depth "
            f"indices equal to (1, 1)'s on {row['equal_to_1x1']:.5f}; launches "
            f"{row['launches']}")
    log(f"  summary: {json.dumps(rep['summary'])}")
    with open(os.path.join(HERE, "SCALING.json")) as f:
        diffs = scaling_fields_match(rep, json.load(f))
    if diffs:
        raise AssertionError(f"the report's fields differ from SCALING.json's: {diffs}")
    launches = {k: sum(r["launches"][k] for r in rows) for k in sb.KERNELS}
    return {"launches": launches, "report": rep}


def optional_modules() -> str:
    """Which of the optional host packages import here."""
    import importlib

    found = []
    for name in ("cv2", "yaml", "h5py", "scipy"):
        try:
            importlib.import_module(name)
            found.append(f"{name} yes")
        except ImportError:
            found.append(f"{name} no")
    return ", ".join(found)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from dvs_mcemvs_torch.device import require_cuda
    from dvs_mcemvs_torch.kernels import _build, binning, probes, resample

    t_start = time.perf_counter()
    marks = []

    def phase(title=None):
        """Log the seconds of the phase that ends here, then `title`."""
        now = time.perf_counter()
        if marks:
            marks[-1] = now - marks[-1]
            log(f"  phase {len(marks)} in {marks[-1]:.1f} s")
        if title:
            marks.append(now)
            log(f"[{len(marks)}/15] {title}")

    dev = require_cuda()
    smi = nvidia_smi_line()
    phase(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    log(f"  optional host modules: {optional_modules()}")

    phase("build (nvcc, sm_90a, one process per source)")
    t0 = time.perf_counter()
    _build.build("binning", "resample", "probes")
    for lib in (binning, resample, probes):
        lib._library()
    log(f"  built in {time.perf_counter() - t0:.2f} s")
    for name, (seconds, report) in _build.BUILD_INFO.items():
        lines = [ln.strip() for ln in report.splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}: nvcc {seconds:.2f} s; " + " | ".join(lines))

    phase("kernels vs plain versions at the headline shapes, and past the 65,535 cap")
    results = kernel_phase(dev)

    phase(f"process_1 chunk: 2 x {N_EVENTS} events, {WIDTH}x{HEIGHT}x{DIM_Z}")
    workload = build_workload(dev)
    torch.cuda.reset_peak_memory_stats()
    launches, seconds, masses = chunk_phase(dev, workload)
    med = float(np.median(seconds))
    log(f"  seconds per chunk (median of {len(seconds)} after a warm-up): {med:.6f} "
        f"[{', '.join(f'{s:.6f}' for s in seconds)}]; {2 * N_EVENTS / med / 1e6:.3f} Mev/s; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; {smi}")

    phase("golden gate: BENCH16 on the literal spec; scored under i8 and the flat merge")
    golden_phase(dev)

    phase(f"spec forms on the headline chunk; {smi}")
    forms = specs_phase(dev, workload, masses)
    launches["bin_events_int8"] = forms[I8_SPEC]["launches"]["bin_events"]
    log("  sort against the exact scatter on the headline chunk")
    sort_vs_scatter_phase(workload)
    log("  the card against the CPU on a small chunk")
    device_vs_cpu_phase(dev)

    phase("dense binning path and platform probes")
    launches["bin_events_dense"] = dense_phase(dev, workload)
    _, probe_launches = probe_phase()
    for name in ("smem_copy", "block_step", "hbm_stream", "dyn_slice"):
        launches[name] = probe_launches[name]

    phase(f"pipelines: process_2/5 on the headline chunk; {smi}")
    temporal_phase(dev, workload, masses, smi=smi)
    # Phase 9's focus collapses run on this chunk's fused DSI, phase 11's grid
    # extras on it and its two camera DSIs.
    headline = run_chunk(workload, HEADLINE_SPEC)[0]
    fused_cpu = headline.fused_dsi.cpu()
    cams_cpu = [headline.dsis[f"camera{c}"].cpu() for c in (0, 1)]
    del headline
    log(f"  full_seq: 2 x {FULL_SEQ_EVENTS} events, RAM and the native event store")
    full_seq_phase(dev, smi=smi)
    log("  the multi-frame golden gate (FULL fixture, full_seq chunking)")
    multiframe_phase(dev)
    log("  the CLI (dvs_mcemvs_torch.cli.main) on the esim fixture")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as workdir:
        cli_phase(dev, workdir)

    phase(f"presets from a ROS1 bag, the focus collapses, a {DEEP_Z}-plane chunk; {smi}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bag_") as workdir:
        bag_phase(dev, workdir, smi=smi)
    log("  focus collapses on the headline chunk's fused DSI, the card against the CPU")
    collapse_phase(dev, fused_cpu, workload[0][0])
    deep_chunk_phase(dev, workload)

    phase(f"distributed: one rank over NCCL, two ranks sharing the card, the CLI as two "
          f"processes; {smi}")
    distributed_phase(dev, workload, smi=smi)

    phase("host API and scripts: vote_dsi, the synthetic demo, the grid extras, "
          "evaluate_dsec, the golden and butterfly probes")
    host_api_phase(dev, workload, fused_cpu, cams_cpu, smi=smi)

    phase(f"programs: the chunk's CUDA graphs against mapper.eager() under every spec; "
          f"{smi}")
    programs = programs_phase(dev, workload)

    phase(f"whole-chunk programs: the reference view, fusion and extraction, process_2's "
          f"temporal step, events on the card, the roofline and the stage profiler; {smi}")
    whole = whole_chunk_phase(dev, workload, results, programs["timing"])

    phase(f"bench: bench_torch.py's steps against mapper.eager(), its stages and its line; "
          f"{smi}")
    bench_phase(dev, whole["roofline"])

    phase(f"scaling: scripts/scaling_bench_torch.py's six meshes on ranks sharing the card; "
          f"{smi}")
    scaling = scaling_phase(dev, smi=smi)
    for name, n in scaling["launches"].items():
        launches[name] += n
    phase()

    binning_src = "dvs_mcemvs_torch/csrc/binning.cu"
    resample_src = "dvs_mcemvs_torch/csrc/resample.cu"
    probes_src = "dvs_mcemvs_torch/csrc/probes.cu"
    sources = {
        "bin_events": (binning_src, "dvs_mcemvs_tpu/kernels/binning_pallas.py:317"),
        "bin_events_int8": (binning_src, "dvs_mcemvs_tpu/kernels/binning_pallas.py:317"),
        "bin_events_dense": (binning_src, "dvs_mcemvs_tpu/kernels/binning_pallas.py:199"),
        "banded_resample_sum": (resample_src, "dvs_mcemvs_tpu/kernels/resample_pallas.py:467"),
        "banded_resample_fanin": (resample_src,
                                  "dvs_mcemvs_tpu/kernels/resample_pallas.py:361"),
        "smem_copy": (probes_src, "scripts/probe_tpu.py:76"),
        "block_step": (probes_src, "scripts/probe_tpu.py:96"),
        "hbm_stream": (probes_src, "scripts/probe_tpu.py:116"),
        "dyn_slice": (probes_src, "scripts/probe_tpu.py:139"),
    }
    missing = [name for name in sources if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on their paths: {missing}")
    keys = ("max_abs_err", "ms", "loop_ms", "timer", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "ceiling_ms", "ceiling_share")
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], **{k: results[name][k] for k in keys}}
               for name, (src, rep) in sources.items()]
    log(f"total {time.perf_counter() - t_start:.1f} s; phases "
        f"{', '.join(f'{t:.1f}' for t in marks)} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
