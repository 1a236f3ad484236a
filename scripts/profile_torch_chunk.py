"""Where the time of the PyTorch port's chunk goes, on a GPU: the one stage
profiler, counterpart of the JAX package's profile_chunk.py,
profile_vote_stages.py, profile_voting.py, profile_specs.py and
profile_extract.py.

By default (`--stages chunk`) it runs the headline chunk of chip_smoke.py
(2 x 1 Mi events, 640x480x100, `hist:g16,seg16,bf,pl`) under torch.profiler
after two warm-up chunks, once on the chunk's programs (CUDA graphs:
`mapper.evaluate_dsi`, `pipeline.fuse_dsis`, `mapper.get_depth_map`) and
once eagerly (`mapper.eager()`), and prints for each: wall time, device
busy time and idle share, host launch calls, device time by kernel
(grouped by name); then a second profiled chunk with a device sync after
each stage (warp+vote, fusion, extraction) for each stage's host launch
calls, device operations, busy time and idle share.  Further splits:

  --stages vote     one camera's warp / binning / merge / sweep
                    (profile_vote_stages.py, profile_voting.py);
  --stages extract  the extraction's collapse / normalize+AGT / median /
                    border (profile_extract.py);
  --specs S1 S2     the voting step of each spec (both cameras'
                    evaluate_dsi; alone, profile_specs.py's five);
  --process 2       one process_2 AM call (4 sub-intervals).

Every split runs on programs (each stage its own CUDA graph, replayed) and
eagerly, and prints launch calls, device operations, busy ms and idle share
per stage; the card's name and power limit head the output.  `--trace DIR`
also writes the chunk's Chrome traces.  `profile_sharded_chunk` profiles a
chunk through a rank's sharded step the same way (chip_smoke.py phase 10
calls it on each of its meshes).  Without a CUDA device it raises.

    python3 scripts/profile_torch_chunk.py [--stages chunk,vote,extract]
        [--specs [SPEC ...]] [--process 2] [--trace out/]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

STAGES = ("warp+vote", "fusion", "extraction")
VOTE_STAGES = ("warp", "binning", "merge", "sweep")
EXTRACT_STAGES = ("collapse", "normalize+AGT", "median", "border")
# scripts/profile_specs.py's DEFAULT_SPECS.
DEFAULT_SPECS = ("hist:g16,seg16,bf,pl", "hist:g8,seg16,bf,pl", "hist:g8,seg8,bf,pl",
                 "hist:g4,seg16,bf,pl", "hist:g8,seg16,pl")
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
    from dvs_mcemvs_torch.ops import extract

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
            fused = pipeline.fuse_dsis(dsis, 2)
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

    return dict(_summary(prof, wall_us), stages=_stage_rows(prof_staged, STAGES))


def _stage_rows(prof, names) -> dict:
    """Each named `record_function` range of a profile (a stage ending in a
    device sync): its host launch calls and copies, device operations,
    device busy ms, wall ms and idle share."""
    events_s = list(prof.events())
    stages = {}
    for name in names:
        rng = next(e for e in events_s if e.name == name and e.device_type == DeviceType.CPU)
        lo, hi = rng.time_range.start, rng.time_range.end

        def inside(e):
            return lo <= e.time_range.start <= hi

        host = [e for e in events_s if e.device_type == DeviceType.CPU and inside(e)]
        # (the stages' own ranges also show on the device's timeline)
        dev = [e for e in events_s if e.device_type == DeviceType.CUDA and inside(e)
               and e.name not in names]
        busy, wall = _busy_us(dev) / 1e3, (hi - lo) / 1e3
        stages[name] = dict(launches=sum(e.name in LAUNCH_CALLS for e in host),
                            copies=sum(e.name in COPY_CALLS for e in host),
                            device_ops=len(dev), busy_ms=busy, wall_ms=wall,
                            idle_share=1 - busy / wall if wall > 0 else 0.0)
    return stages


def profile_stages(fns: dict, programs: bool) -> dict:
    """Each of `fns` (name -> a function of device tensors, reading nothing
    back) run alone after a warm-up, with a device sync after it, under
    torch.profiler: on programs each is one CUDA graph (`graphs.Captured`,
    captured at the warm-up) replayed, eagerly its PyTorch calls.  Weight
    checks are deferred to a device flag.  Returns `_stage_rows`' rows."""
    from dvs_mcemvs_torch import graphs
    from dvs_mcemvs_torch.kernels import binning

    dev = torch.device("cuda", torch.cuda.current_device())
    flag = binning.fault_flag(dev)
    runs = {}
    for name, fn in fns.items():
        if programs:
            prog = graphs.Captured(dev, [], fn)
            prog()
            runs[name] = functools.partial(prog, fresh_out=False)
        else:
            def run(fn=fn):
                with binning.deferred_weight_checks(flag):
                    return fn()
            runs[name] = run
        runs[name]()
        torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for name, run in runs.items():
            with record_function(name):
                run()
                torch.cuda.synchronize()
    binning.raise_weight_faults(flag)
    return _stage_rows(prof, list(fns))


def vote_stage_fns(workload, spec: str) -> dict:
    """One camera's warp, binning, merge and sweep on their own inputs
    (scripts/roofline_torch.py's `Stages`)."""
    import roofline_torch

    st = roofline_torch.Stages(workload, spec)
    st.check()
    return {name: st.fns[name] for name in VOTE_STAGES}


def extract_stage_fns(fused, depth_vec, options=None) -> dict:
    """The extraction's sub-chains of a fused DSI, each on the previous
    one's outputs (as profile_extract.py bisects them): the collapse,
    normalize + adaptive threshold, the masked median, the border and the
    index-to-depth map."""
    from dvs_mcemvs_torch.ops import extract, grid as gridops

    opts = options or extract.DepthMapOptions()
    conf, idx = gridops.collapse(fused, opts.collapse_method)

    def norm_agt():
        conf_u8 = extract.normalize_confidence(conf, opts.max_confidence)
        return extract.adaptive_threshold_mask(conf_u8, opts.adaptive_threshold_kernel_size,
                                               opts.adaptive_threshold_c)

    mask = norm_agt()

    def median():
        return extract.masked_median_filter_u8(idx.to(torch.float32), mask,
                                               opts.median_filter_size, levels=depth_vec.n)

    filtered = median()

    def border():
        b = max(opts.adaptive_threshold_kernel_size // 2, 1)
        return (extract.remove_mask_boundary(mask, b),
                depth_vec.depth_at_index(torch.clamp(filtered, 0, depth_vec.n - 1)))

    return {"collapse": lambda: gridops.collapse(fused, opts.collapse_method),
            "normalize+AGT": norm_agt, "median": median, "border": border}


def profile_split(fns: dict) -> dict:
    """`profile_stages` of `fns` on programs and eagerly:
    {"programs": rows, "eager": rows}."""
    return {mode: profile_stages(fns, mode == "programs") for mode in ("programs", "eager")}


def profile_call(fn, eager: bool) -> dict:
    """One call of `fn` (which ends in a device sync) under torch.profiler
    after two warm-ups, on programs or eagerly: `_summary`'s keys."""
    from dvs_mcemvs_torch import mapper as mappermod

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with mappermod.eager() if eager else contextlib.nullcontext():
        fn()
        fn()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            wall_us = (time.perf_counter() - t0) * 1e6
    return _summary(prof, wall_us)


def voting_step(workload, spec: str, ts: float = 0.5):
    """Both cameras' `evaluate_dsi` under `spec` (the voting step of
    profile_specs.py), ending in a device sync."""
    from dvs_mcemvs_torch import mapper as mappermod, pipeline

    mappers, events, trajs, _ = workload
    T_rv_w = pipeline.place_reference_view(trajs[0], ts)

    def step():
        for m, ev, tr in zip(mappers, events, trajs):
            mappermod.evaluate_dsi(m, ev, tr, T_rv_w, packet_size=1024, backend=spec,
                                   pad="bucket")
        torch.cuda.synchronize()
        mappermod.check_faults()
    return step


def process_2_call(workload, spec: str, intervals: int = 4, ts: float = 0.5):
    """One process_2 AM call of `intervals` sub-intervals, ending in a
    device sync."""
    from dvs_mcemvs_torch import pipeline

    mappers, events, trajs, _ = workload
    vopts = pipeline.VotingOptions(packet_size=1024, backend=spec, pad_policy="bucket")

    def call():
        pipeline.process_2(mappers, events, trajs, ts, stereo_fusion=2,
                           temporal_fusion=pipeline.TEMPORAL_AM, num_intervals=intervals,
                           vopts=vopts)
        torch.cuda.synchronize()
    return call


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


def report_stages(rows: dict, what: str, log=print) -> None:
    """Log `_stage_rows`' rows."""
    for stage, r in rows.items():
        log(f"{what} {stage}: {r['launches']} launch calls, {r['copies']} copies, "
            f"{r['device_ops']} device operations, device busy {r['busy_ms']:.3f} ms of "
            f"{r['wall_ms']:.3f} ms (synchronised stage), idle share {r['idle_share']:.3f}")


def report(out: dict, what: str, top: int = 30, log=print) -> None:
    log(f"{what}: wall {out['wall_ms']:.3f} ms (profiled); device busy "
        f"{out['busy_ms']:.3f} ms; idle share {out['idle_share']:.3f}; {out['launches']} "
        f"launch calls, {out['copies']} copies, {out['device_ops']} device operations")
    report_stages(out["stages"], " ", log)
    log(f"  {'device ms':>10} {'calls':>6}  kernel")
    for name, n, ms in out["kernels"][:top]:
        log(f"  {ms:10.3f} {n:6d}  {name[:110]}")


def run(workload, stages=("chunk",), specs=(), process=0, spec="hist:g16,seg16,bf,pl",
        trace="", top=30, log=print) -> dict:
    """The profiles that `main` prints, as a dict by split and mode."""
    out = {}
    mappers = workload[0]
    if "chunk" in stages:
        for eager in (False, True):
            mode = "eager" if eager else "programs"
            out[f"chunk {mode}"] = res = profile_chunk(workload, spec, eager, trace=trace)
            report(res, f"chunk {mode}", top, log)
    if "vote" in stages:
        for mode, rows in profile_split(vote_stage_fns(workload, spec)).items():
            out[f"vote {mode}"] = rows
            report_stages(rows, f"vote ({spec}) {mode}", log)
    if "extract" in stages:
        import chip_smoke as cs

        fused = cs.run_chunk(workload, spec)[0].fused_dsi
        for mode, rows in profile_split(extract_stage_fns(fused, mappers[0].depth_vec)).items():
            out[f"extract {mode}"] = rows
            report_stages(rows, f"extract {mode}", log)
    for s in specs:
        for eager in (False, True):
            mode = "eager" if eager else "programs"
            out[f"voting {s} {mode}"] = res = profile_call(voting_step(workload, s), eager)
            report(res, f"voting step {s} {mode}", 5, log)
    if process == 2:
        for eager in (False, True):
            mode = "eager" if eager else "programs"
            out[f"process_2 {mode}"] = res = profile_call(process_2_call(workload, spec), eager)
            report(res, f"process_2 AM, 4 sub-intervals, {spec} {mode}", 10, log)
    elif process:
        raise ValueError(f"--process takes 2, got {process}")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--stages", default="chunk",
                        help="comma-separated splits: chunk, vote, extract (default chunk)")
    parser.add_argument("--specs", nargs="*", default=None,
                        help="profile the voting step of each of these specs (alone: "
                             "profile_specs.py's five)")
    parser.add_argument("--process", type=int, default=0, help="2: one process_2 AM call")
    parser.add_argument("--spec", default="hist:g16,seg16,bf,pl")
    parser.add_argument("--trace", default="", help="write the Chrome traces into this directory")
    args = parser.parse_args(argv)
    stages = [s for s in args.stages.split(",") if s]
    unknown = set(stages) - {"chunk", "vote", "extract"}
    if unknown:
        parser.error(f"unknown --stages {sorted(unknown)}")
    from dvs_mcemvs_torch.device import require_cuda

    dev = require_cuda()
    import chip_smoke as cs

    print(cs.nvidia_smi_line())
    specs = DEFAULT_SPECS if args.specs == [] else args.specs or ()
    run(cs.build_workload(dev), stages, specs, args.process, args.spec, args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
