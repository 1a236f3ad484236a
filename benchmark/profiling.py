"""A traced run's profiled stretch, and the arithmetic that reads it.

`busy_us` is scripts/profile_torch_chunk.py's `_busy_us` (lines 64-75),
copied: the microseconds in which at least one device operation runs.
The stretch is `n` chunks driven as the window drives them, after the
window, under torch.profiler (host and CUDA activity), with host ranges
"process" and "extract" around the calls into the pipeline and the save
step; it ends when the last chunk's maps are on the host.
"""

from __future__ import annotations

import collections
import time
from typing import List, Optional, Tuple

import torch

# Host ranges the harness opens in the stretch; the profiler shows them on
# the device's timeline too, where they are not device work.
RANGES = ("process", "extract")
TOP = 10


def busy_us(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """Microseconds in which at least one interval runs, and the merged
    intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    merged = []
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                merged.append((cur_s, cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        merged.append((cur_s, cur_e))
    return busy, merged


def summarize(events, wall_s: float, n: int) -> Optional[dict]:
    """The stretch's device busy seconds, its length, the longest device
    operations by name and the longest idle gaps, each gap named by the host
    range it fell in."""
    from torch.autograd import DeviceType

    dev = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in RANGES]
    if not dev:
        return None
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CPU and e.name in RANGES]
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    busy, merged = busy_us(spans)
    by_name = collections.defaultdict(float)
    for e in dev:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e6
    gaps = []
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        where = next((name for a, b, name in host if a <= e0 <= b), "scheduler")
        gaps.append((where, (s1 - e0) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy / 1e6, "window_s": wall_s, "chunks": n,
            "device_ops": [[name[:160], secs] for name, secs in ops[:TOP]],
            "idle_gaps": [[name, secs] for name, secs in gaps[:TOP]]}


def profile_stretch(drv, n: int, device) -> Optional[dict]:
    """Profile `n` chunks of `drv`, back to back."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prev, drv._span = drv._span, record_function
    try:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                drv.step()
            drv.drain()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
    finally:
        drv._span = prev
    return summarize(prof.events(), wall, n)
