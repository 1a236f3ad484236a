"""Platform ceilings of an NVIDIA GPU: the counterpart of scripts/probe_tpu.py.

Four probe kernels (dvs_mcemvs_torch/kernels/probes.py, csrc/probes.cu) at
the TPU probes' shapes separate the resources a kernel of this repo can be
bound by, plus the host link:

  1. smem copy:   shared-memory bandwidth and its share of the on-chip
                  ceiling (TPU: VMEM round trip, run_c)
  2. block step:  the device's launch latency (one block), the cost of a
                  one-warp block (the slope from 4,096 to 65,536 blocks),
                  torch.add on the same tile, and the host's cost of one
                  launch from Python through ctypes (TPU: empty grid step,
                  run_e)
  3. hbm stream:  device-memory read bandwidth over 576 x 896 bf16 blocks
                  (~1 MB each; TPU: run_f), its share of 3.35 TB/s, and
                  torch.sum over the same stream
  4. dyn slice:   16-byte loads at computed row offsets from rows staged in
                  shared memory, and their share of the on-chip ceiling
                  (TPU: dynamic-slice traffic, run_d)
  5. host link:   pageable and pinned host -> device copies, device -> host
                  copies, at 1, 4 and 16 MB

A device time is the card's alone: after a warm-up, calls captured into one
CUDA graph (as many as fill a third of `--min-time`, at most 1,000) are
replayed between two CUDA events, best of three replays.  Host times are
loops timed to `--min-time` by the host clock.  The on-chip ceiling of the
two shared-memory probes is the bytes each is defined to move through
shared memory over the SMs' ports, 128 bytes a clock an SM, at the card's
top SM clock (`nvidia-smi` clocks.max.sm; the clock read after the probe,
clocks.sm, is printed beside it).  Every line ends with the card's name and
power limit.  Without a CUDA device it raises.

`--root DIR` times the probes of the port in DIR (a checkout or a `git
archive` of another commit; its kernels build under DIR/build/) by this
script's timers, so that two commits compare by one method on one card:

    python3 scripts/probe_gpu.py [--min-time 1.5] [--root DIR]
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

H, W = 576, 896   # the voting grid's padded histogram block
G = 256           # blocks of the HBM stream
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
STEP_BLOCKS = (1, 4096, 65536)   # block_step: one block, ~one wave, ~16 waves
MAX_GRAPH_CALLS = 1000
SMEM_BYTES_PER_CLOCK = 128       # an SM's shared-memory port (Hopper white paper)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def sm_clocks_mhz() -> tuple:
    """(the SM clock now, the top SM clock) of the first card, MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    now, top = out.strip().splitlines()[0].split(",")
    return float(now), float(top)


def ceiling_ms(onchip_bytes: float, n_sms: int, mhz: float) -> float:
    """The least time to move `onchip_bytes` through the SMs' shared-memory
    ports at `mhz`."""
    return onchip_bytes / (n_sms * SMEM_BYTES_PER_CLOCK * mhz * 1e6) * 1e3


def smem_copy_bytes(n: int, passes: int, reps: int) -> int:
    """smem_copy's shared-memory traffic over n floats: a 16-byte store and
    a 16-byte load a vector, passes x reps times."""
    return passes * reps * n * 4 * 2


def dyn_slice_bytes(w: int, qv: int, n_offsets: int, steps: int) -> int:
    """dyn_slice's loads from shared memory: a row of qv x w floats an
    offset and step."""
    return steps * n_offsets * qv * w * 4


def cuda_graph_ms(fn, min_time: float) -> float:
    """Device milliseconds per call of `fn` alone, without the host's cost
    of making the call: one warm-up call, as many calls as fill a third of
    `min_time` (10 to MAX_GRAPH_CALLS) captured into one CUDA graph, the
    graph replayed between two CUDA events, best of three replays.  `fn`
    must not wait for the card."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    one = max(start.elapsed_time(end) / 1e3, 1e-6)
    calls = int(np.clip(math.ceil(min_time / 3 / one), 10, MAX_GRAPH_CALLS))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    best = math.inf
    for _ in range(3):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    return best


def host_timeit_s(fn, min_time: float) -> float:
    """Seconds per call of `fn`, which ends in a device sync, by the host
    clock: best of three loops that fill `min_time` seconds."""
    fn()
    t0 = time.perf_counter()
    fn()
    iters = int(np.clip(math.ceil(min_time / max(time.perf_counter() - t0, 1e-6)), 3, 5000))
    best = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def measure(min_time: float = 1.5, log=print) -> dict:
    """Run every probe on the first CUDA device; returns the numbers that
    `log` printed, by name."""
    from dvs_mcemvs_torch.device import require_cuda
    from dvs_mcemvs_torch.kernels import probes

    dev = require_cuda()
    smi = nvidia_smi_line()
    res = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}

    def emit(key, value, text):
        res[key] = value
        log(f"{text}  [{smi}]")

    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def onchip(key, what, onchip_bytes, ms):
        now, top = sm_clocks_mhz()
        ceiling = ceiling_ms(onchip_bytes, n_sms, top)
        res[f"{key}_ms"], res[f"{key}_ceiling_ms"] = ms, ceiling
        emit(f"{key}_tb_s", onchip_bytes / ms / 1e9,
             f"{what}: {onchip_bytes / ms / 1e9:.3f} TB/s ({ms:.4f} ms), {ceiling / ms:.1%} "
             f"of the on-chip ceiling {ceiling:.4f} ms ({n_sms} SMs x "
             f"{SMEM_BYTES_PER_CLOCK} B a clock at {top:.0f} MHz; SM clock read after it "
             f"{now:.0f} MHz)")

    a32 = torch.ones((1, H, W), dtype=torch.float32, device=dev)
    onchip("smem", "smem copy", smem_copy_bytes(H * W, probes.PASSES, probes.REPS),
           cuda_graph_ms(lambda: probes.smem_copy(a32), min_time))

    tile = torch.ones((1, 8, 128), dtype=torch.float32, device=dev)
    step_us = {n: cuda_graph_ms(lambda: probes.block_step(tile, n), min_time) * 1e3
               for n in STEP_BLOCKS}
    add_us = cuda_graph_ms(lambda: torch.add(tile, 1.0), min_time) * 1e3
    lo, hi = STEP_BLOCKS[1:]
    slope_ns = (step_us[hi] - step_us[lo]) * 1e3 / (hi - lo)
    res["block_step_us"], res["torch_add_us"] = step_us, add_us
    emit("launch_latency_us", step_us[1],
         f"block step: device launch latency {step_us[1]:.3f} us (1 block; "
         f"torch.add on the tile {add_us:.3f} us)")
    emit("block_step_ns", slope_ns,
         f"block step: {slope_ns:.3f} ns per one-warp block ({lo} blocks in "
         f"{step_us[lo]:.3f} us, {hi} in {step_us[hi]:.3f} us)")
    n_launch = 2000

    def launches():
        for _ in range(n_launch):
            probes.block_step(tile, n_blocks=1)
        torch.cuda.synchronize()

    us = host_timeit_s(launches, min_time) / n_launch * 1e6
    emit("launch_us", us, f"launch: {us:.2f} us per back-to-back launch from Python "
         "(wrapper + ctypes + launch)")

    big = torch.ones((G, H, W), dtype=torch.bfloat16, device=dev)
    read = big.numel() * 2
    block_mb = H * W * 2 / 2**20
    ms = cuda_graph_ms(lambda: probes.hbm_stream(big), min_time)
    emit("hbm_gb_s", read / ms / 1e6,
         f"hbm stream: {read / ms / 1e6:.1f} GB/s, {read / ms * 1e3 / HBM_BYTES_PER_S:.1%} "
         f"of 3.35 TB/s ({ms:.4f} ms, {ms * 1e3 / G:.3f} us per {block_mb:.2f} MiB "
         f"block)")
    res["hbm_us_per_block"] = ms * 1e3 / G
    ms = cuda_graph_ms(lambda: torch.sum(big, 0, keepdim=True, dtype=torch.float32),
                       min_time)
    emit("torch_sum_gb_s", read / ms / 1e6,
         f"torch.sum over the same stream: {read / ms / 1e6:.1f} GB/s ({ms:.4f} ms)")
    del big

    onchip("dyn_slice", "dyn slice: loads at computed offsets",
           dyn_slice_bytes(W, probes.QV, probes.N_OFFSETS, probes.STEPS),
           cuda_graph_ms(lambda: probes.dyn_slice(a32), min_time))

    for mb in (1, 4, 16):
        host = torch.ones(mb * 2**20 // 4, dtype=torch.float32)
        pinned = host.pin_memory()
        on_dev = host.to(dev)

        def h2d(src, non_blocking):
            src.to(dev, non_blocking=non_blocking)
            torch.cuda.synchronize()

        def d2h():
            on_dev.to("cpu")

        rates = {
            "h2d_pageable": mb / host_timeit_s(lambda: h2d(host, False), min_time / 3),
            "h2d_pinned": mb / host_timeit_s(lambda: h2d(pinned, True), min_time / 3),
            "d2h": mb / host_timeit_s(d2h, min_time / 3),
        }
        emit(f"host_link_{mb}mb", rates,
             f"host link {mb:2d} MB: H2D pageable {rates['h2d_pageable']:8.1f} MB/s, "
             f"H2D pinned {rates['h2d_pinned']:8.1f} MB/s, D2H {rates['d2h']:8.1f} MB/s")
    return res


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--min-time", type=float, default=1.5,
                        help="seconds each timed loop runs (default 1.5)")
    parser.add_argument("--root", default=REPO,
                        help="the checkout whose dvs_mcemvs_torch is timed (default: this one)")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import dvs_mcemvs_torch

    print(f"port: {os.path.dirname(dvs_mcemvs_torch.__file__)}")
    measure(args.min_time)


if __name__ == "__main__":
    main()
