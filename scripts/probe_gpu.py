"""Platform ceilings of an NVIDIA GPU: the counterpart of scripts/probe_tpu.py.

Four probe kernels (dvs_mcemvs_torch/kernels/probes.py, csrc/probes.cu) at
the TPU probes' shapes separate the resources a kernel of this repo can be
bound by, plus the host link:

  1. smem copy:   shared-memory bandwidth (TPU: VMEM round trip, run_c)
  2. block step:  cost of one block and of one launch from Python through
                  ctypes (TPU: empty grid step, run_e)
  3. hbm stream:  device-memory read bandwidth over 576 x 896 bf16 blocks
                  (~1 MB each; TPU: run_f)
  4. dyn slice:   loads at computed row offsets from an L2-resident array
                  (TPU: dynamic-slice traffic, run_d)
  5. host link:   pageable and pinned host -> device copies, device -> host
                  copies, at 1, 4 and 16 MB

Each probe runs a loop timed to `--min-time` seconds with CUDA events after a
warm-up, and reports the fastest of three such loops.  Every line ends with
the card's name and power limit.  Without a CUDA device it raises.

    python3 scripts/probe_gpu.py [--min-time 1.5]
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


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_timeit_ms(fn, min_time: float) -> float:
    """Milliseconds per call of `fn` on the card: one warm-up call, a
    count of calls that fills `min_time` seconds, best of three loops timed
    with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    one = max(start.elapsed_time(end) / 1e3, 1e-6)
    iters = int(np.clip(math.ceil(min_time / one), 5, 5000))
    best = math.inf
    for _ in range(3):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
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

    a32 = torch.ones((1, H, W), dtype=torch.float32, device=dev)
    ms = cuda_timeit_ms(lambda: probes.smem_copy(a32), min_time)
    smem_bytes = probes.PASSES * probes.REPS * H * W * 4 * 2   # a store and a load
    emit("smem_tb_s", smem_bytes / ms / 1e9, f"smem copy: {smem_bytes / ms / 1e9:.3f} TB/s")

    tile = torch.ones((1, 8, 128), dtype=torch.float32, device=dev)
    ms = cuda_timeit_ms(lambda: probes.block_step(tile), min_time)
    emit("block_step_ns", ms * 1e6 / probes.N_BLOCKS,
         f"block step: {ms * 1e6 / probes.N_BLOCKS:.2f} ns per one-warp block "
         f"({probes.N_BLOCKS} blocks in {ms * 1e3:.2f} us)")
    n_launch = 2000

    def launches():
        for _ in range(n_launch):
            probes.block_step(tile, n_blocks=1)
        torch.cuda.synchronize()

    us = host_timeit_s(launches, min_time) / n_launch * 1e6
    emit("launch_us", us, f"launch: {us:.2f} us per back-to-back launch from Python "
         "(wrapper + ctypes + launch)")

    big = torch.ones((G, H, W), dtype=torch.bfloat16, device=dev)
    ms = cuda_timeit_ms(lambda: probes.hbm_stream(big), min_time)
    block_mb = H * W * 2 / 2**20
    emit("hbm_gb_s", big.numel() * 2 / ms / 1e6,
         f"hbm stream: {big.numel() * 2 / ms / 1e6:.1f} GB/s "
         f"({ms * 1e3 / G:.3f} us per {block_mb:.2f} MiB block)")
    res["hbm_us_per_block"] = ms * 1e3 / G
    del big

    ms = cuda_timeit_ms(lambda: probes.dyn_slice(a32), min_time)
    dyn_bytes = probes.STEPS * probes.N_OFFSETS * probes.QV * W * 4   # bytes loaded
    emit("dyn_slice_tb_s", dyn_bytes / ms / 1e9,
         f"dyn slice: {dyn_bytes / ms / 1e9:.3f} TB/s loaded at computed offsets")

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
    measure(parser.parse_args().min_time)


if __name__ == "__main__":
    main()
