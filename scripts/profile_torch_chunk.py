"""Where the time of one process_1 chunk of the PyTorch port goes, on a GPU.

Runs the headline chunk of chip_smoke.py (2 x 1 Mi events, 640x480x100,
`hist:g16,seg16,bf,pl`) under torch.profiler after two warm-up chunks, once
on the chunk's programs (CUDA graphs, `mapper.evaluate_dsi`) and once
eagerly (`mapper.eager()`), and prints for each: wall time, device busy
time and idle share, device time by kernel (grouped by name); then a second
profiled chunk with a device sync after each stage (warp+vote, fusion,
extraction) for each stage's host launch calls, device operations and
device busy time.  `--trace DIR` also writes the Chrome traces.
`profile_sharded_chunk` profiles a chunk through a rank's sharded step the
same way, with the whole step's launch calls and copies (chip_smoke.py
phase 10 calls it on each of its meshes).

    python3 scripts/profile_torch_chunk.py [--trace out/]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

STAGES = ("warp+vote", "fusion", "extraction")
# The CUDA runtime calls that put work on a stream, as the profiler names
# them: kernel and graph launches, and copies and fills.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelEx",
                "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch")
COPY_CALLS = ("cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy", "cudaMemset")


def _busy_us(events) -> float:
    """Microseconds in which at least one of the device events runs."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in events):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (0.0 if cur_e is None else cur_e - cur_s)


def profile_chunk(workload, spec: str, eager: bool, ts: float = 0.5, trace: str = "") -> dict:
    """Profile the chunk of `workload` (chip_smoke.build_workload) under
    `spec`, on programs or eagerly.  Returns {wall_ms, busy_ms, idle_share,
    kernels: [(name, calls, device ms)], stages: {stage: {launches, copies,
    device_ops, busy_ms, wall_ms}}}."""
    from dvs_mcemvs_torch import mapper as mappermod, pipeline
    from dvs_mcemvs_torch.ops import extract, grid as gridops

    mappers, events, trajs, _ = workload
    kw = dict(packet_size=1024, backend=spec, pad="bucket")
    mode = mappermod.eager() if eager else contextlib.nullcontext()

    vopts = pipeline.VotingOptions(packet_size=kw["packet_size"], backend=spec,
                                   pad_policy="bucket")

    def chunk():
        res = pipeline.process_1(mappers, events, trajs, ts, stereo_fusion=2, vopts=vopts)
        mappermod.get_depth_map(mappers[0], res.fused_dsi, extract.DepthMapOptions())
        torch.cuda.synchronize()

    def staged():
        T_rv_w = pipeline.place_reference_view(trajs[0], ts)
        with record_function("warp+vote"):
            dsis = [mappermod.evaluate_dsi(m, ev, tr, T_rv_w, **kw)
                    for m, ev, tr in zip(mappers, events, trajs)]
            torch.cuda.synchronize()
        with record_function("fusion"):
            fused = gridops.fuse_many(dsis, 2)
            torch.cuda.synchronize()
        with record_function("extraction"):
            mappermod.get_depth_map(mappers[0], fused, extract.DepthMapOptions())
            torch.cuda.synchronize()

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with mode:
        chunk()
        chunk()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            chunk()
            wall_us = (time.perf_counter() - t0) * 1e6
        staged()
        with profile(activities=acts) as prof_staged:
            staged()
    if trace:
        os.makedirs(trace, exist_ok=True)
        tag = "eager" if eager else "programs"
        prof.export_chrome_trace(os.path.join(trace, f"chunk_{tag}.json"))
        prof_staged.export_chrome_trace(os.path.join(trace, f"chunk_{tag}_stages.json"))

    events_s = list(prof_staged.events())
    stages = {}
    for name in STAGES:
        rng = next(e for e in events_s if e.name == name and e.device_type == DeviceType.CPU)
        lo, hi = rng.time_range.start, rng.time_range.end

        def inside(e):
            return lo <= e.time_range.start <= hi

        host = [e for e in events_s if e.device_type == DeviceType.CPU and inside(e)]
        # (the stages' own ranges also show on the device's timeline)
        dev = [e for e in events_s if e.device_type == DeviceType.CUDA and inside(e)
               and e.name not in STAGES]
        stages[name] = dict(launches=sum(e.name in LAUNCH_CALLS for e in host),
                            copies=sum(e.name in COPY_CALLS for e in host),
                            device_ops=len(dev), busy_ms=_busy_us(dev) / 1e3,
                            wall_ms=(hi - lo) / 1e3)
    return dict(_summary(prof, wall_us), stages=stages)


def _summary(prof, wall_us: float) -> dict:
    """A profiled chunk's wall, device busy time and idle share, its host
    launch calls and copies, and device time by kernel."""
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    busy = _busy_us(dev_events)
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in dev_events:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    kernels = sorted(((name, n, us / 1e3) for name, (n, us) in by_name.items()),
                     key=lambda r: -r[2])
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3, idle_share=1 - busy / wall_us,
                launches=sum(e.name in LAUNCH_CALLS for e in host),
                copies=sum(e.name in COPY_CALLS for e in host), device_ops=len(dev_events),
                kernels=kernels, stages={})


def profile_sharded_chunk(workload, mesh, step, tables, eager: bool) -> dict:
    """Profile one chunk of `workload` through this rank's sharded `step`
    on `mesh` (`chip_smoke.sharded_chunk`: the events padded on the host,
    the step, a device sync), on its programs or eagerly, after two
    warm-up chunks.  Returns `profile_chunk`'s keys (no stages)."""
    import chip_smoke as cs
    from dvs_mcemvs_torch import mapper as mappermod

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with mappermod.eager() if eager else contextlib.nullcontext():
        for _ in range(2):
            cs.sharded_chunk(workload, mesh, step, tables)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            cs.sharded_chunk(workload, mesh, step, tables)
            wall_us = (time.perf_counter() - t0) * 1e6
    return _summary(prof, wall_us)


def report(out: dict, what: str, top: int = 30, log=print) -> None:
    log(f"{what}: chunk wall {out['wall_ms']:.3f} ms (profiled); device busy "
        f"{out['busy_ms']:.3f} ms; idle share {out['idle_share']:.3f}; {out['launches']} "
        f"launch calls, {out['copies']} copies, {out['device_ops']} device operations")
    for stage, r in out["stages"].items():
        log(f"  {stage}: {r['launches']} launch calls, {r['copies']} copies, "
            f"{r['device_ops']} device operations, device busy {r['busy_ms']:.3f} ms of "
            f"{r['wall_ms']:.3f} ms (synchronised stage)")
    log(f"  {'device ms':>10} {'calls':>6}  kernel")
    for name, n, ms in out["kernels"][:top]:
        log(f"  {ms:10.3f} {n:6d}  {name[:110]}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trace", default="", help="write the Chrome traces into this directory")
    args = parser.parse_args()
    import chip_smoke as cs
    from dvs_mcemvs_torch.device import require_cuda

    dev = require_cuda()
    print(cs.nvidia_smi_line())
    workload = cs.build_workload(dev)
    for eager in (False, True):
        out = profile_chunk(workload, cs.HEADLINE_SPEC, eager, trace=args.trace)
        report(out, "eager" if eager else "programs")


if __name__ == "__main__":
    main()
