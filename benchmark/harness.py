"""The benchmark's harness: one run of one cell of BENCHMARK.json.

A cell names a configuration (`configs/<config>.json`: the preset's flags,
the rig and the scene), a traffic mix (`mixes/<traffic>.json`: the events
a camera a window) and, by its own name, the limits of its
output check (`limits/<cell>.json`); each per-layer metric is read by
`metrics/<metric>.py`.  Nothing here names a cell.

A configuration's `rig` is a calibrated rig of two or three cameras (what
the port's `io.calib.RigCalibration` holds):

    "rig": {
      "cameras": [                      # camera 0 first
        {"width": 640, "height": 480,
         "K": [fx, fy, cx, cy],         # the raw sensor
         "distortion": "radtan",        # "none" | "radtan" | "equidistant"
         "D": [k1, k2, p1, p2],         # radtan: k1, k2, p1, p2[, k3] (OpenCV);
                                        # equidistant: k1..k4 (cv::fisheye)
         "R": [[...], [...], [...]],    # optional rectifying rotation
         "T_i_0": [[...], ..., [...]]}, # 4x4, camera 0's frame -> camera i's;
        ...                             # camera 0's is the identity (may be left out)
      ],
      "P": [fx, fy, cx, cy],            # the shared projection, written out
      "T_hand_eye": [[...], ...],       # optional 4x4: camera 0 in the poses'
                                        # frame (default the identity)
      "poses": {"file": ...} | {"flight": {...}}
    }

Camera i sits at poses o T_hand_eye o T_i_0^-1, as the port's CLI chains a
rig (`cli._build_trajectories`).  The DSI's virtual camera is P's fx on
both axes at P's principal point (`ops.camera.virtual_camera`).

A run drives the port's full_seq path as its CLI does (`cli._run_full_seq`
over events in RAM): `pipeline.run_full_seq` with `pipeline.process_1` or
`process_2`, each chunk's `mapper.get_depth_map` and the maps' copy to the
host on a `utils.writers.SaveWorkerPool` of the preset's save workers (no
files are written).  The harness passes `run_full_seq` a wrapper around
the process function: it opens a chunk's record and, in a traced run, ends
the chunk's span in a device sync.

Steps: make the inputs from the seed (on the device), warm up with one
pass over the segment (every program captured, the extraction programs on
each save worker), drive chunks back to back for `seconds`, judge a sample of the window's
chunks against the plain reference, print the result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import random
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import judge  # noqa: E402
from benchmark.reference import emvs  # noqa: E402
from benchmark.traffic import generate as traffic  # noqa: E402

# Modules that may not be loaded in a run (compared by top-level name).
FORBIDDEN = ("jax", "jaxlib", "flax", "dvs_mcemvs_tpu")
# Chunks profiled after the window in a traced run.
PROFILED_CHUNKS = 12
# Chunks of the window judged against the reference, drawn from the seed.
JUDGED_CHUNKS = 3


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, spec_path: str = "") -> Cell:
    """The cell named `name` of the spec at `spec_path` (BENCHMARK.json by
    default), with its files by name (`configs/`, `mixes/`, `limits/`):
    under benchmark/ for BENCHMARK.json, beside any other spec file (a
    fixture such as tests/evimo2/spec.json)."""
    where = os.path.dirname(os.path.abspath(spec_path)) if spec_path else BENCH
    spec_path = spec_path or os.path.join(ROOT, "BENCHMARK.json")
    spec = _load(spec_path)
    row = next((w for w in spec["workloads"] if w["name"] == name), None)
    if row is None:
        raise KeyError(f"no workload {name!r} in {spec_path}")
    return Cell(name=name,
                config=_load(os.path.join(where, "configs", row["config"] + ".json")),
                mix=_load(os.path.join(where, "mixes", row["traffic"] + ".json")),
                limits=_load(os.path.join(where, "limits", name + ".json")),
                end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"] if _applies(m, name)])


def metric_reader(name: str) -> Callable[[dict], Optional[float]]:
    """`read(trace)` of metrics/<name>.py."""
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# The inputs and the program
# ---------------------------------------------------------------------------


def calibration(rig: dict):
    """The configuration's rig as the port's calibration loaders give one
    (`io.calib.RigCalibration`, each camera by `calib._cam`)."""
    from dvs_mcemvs_torch.io import calib
    from dvs_mcemvs_torch.ops import camera as camops

    models = {"none": camops.NONE, "radtan": camops.PLUMB_BOB, "equidistant": camops.FISHEYE}
    fx, fy, cx, cy = traffic.projection(rig)
    P = [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]]
    cams = traffic.cameras(rig)
    T_he = traffic.hand_eye(rig)
    return calib.RigCalibration(
        cams=tuple(calib._cam(c["width"], c["height"],
                              [[c["K"][0], 0.0, c["K"][2]], [0.0, c["K"][1], c["K"][3]],
                               [0.0, 0.0, 1.0]],
                              c["D"], models[c["distortion"]], c["R"], P) for c in cams),
        T_1_0=cams[1]["T_i_0"], T_2_0=cams[2]["T_i_0"] if len(cams) > 2 else None,
        T_hand_eye=np.eye(4) if T_he is None else T_he)


class Program:
    """The port set up as its CLI sets up a full_seq run of the preset, over
    the cell's inputs."""

    def __init__(self, config: dict, streams, poses, device):
        from dvs_mcemvs_torch import cli, config as cfgmod, mapper, pipeline
        from dvs_mcemvs_torch.ops import extract, trajectory as trajmod

        self.cfg = cfg = cfgmod.parse_args(config["flags"])
        shape = mapper.DsiShape(cfg.dimX, cfg.dimY, cfg.dimZ, cfg.fov_deg, cfg.min_depth,
                                cfg.max_depth)
        rig = calibration(config["rig"])
        self.mappers = [mapper.make_mapper(c, shape, cfg.depth_sampling) for c in rig.cams]
        self.trajs = cli._build_trajectories(trajmod.from_arrays(*poses, device=device), rig,
                                             rig.num_cameras)
        self.events = [mapper.Events(x, y, t) for x, y, t in streams]
        self.opts = extract.DepthMapOptions(
            adaptive_threshold_kernel_size=cfg.adaptive_threshold_kernel_size,
            adaptive_threshold_c=cfg.adaptive_threshold_c,
            median_filter_size=cfg.median_filter_size, full_sequence=cfg.full_seq,
            save_conf_stats=cfg.save_conf_stats, max_confidence=cfg.max_confidence,
            rv_pos=cfg.rv_pos, collapse_method=cfg.collapse_method)
        backend = cfg.splat_backend
        if backend == "auto":
            backend = cli.auto_spec(cfg, self.trajs, self.events, self.mappers[0])
        self.backend = backend
        vopts = pipeline.VotingOptions(packet_size=cfg.packet_size, backend=backend,
                                       plane_block=cfg.plane_block)
        self.fopts = pipeline.FullSeqOptions(
            start_time=cfg.start_time_s, stop_time=cfg.stop_time_s, duration=cfg.duration,
            out_skip=cfg.out_skip, forward_looking=cfg.forward_looking)
        if cfg.process_method == 1:
            self.process = pipeline.process_1
            self.kwargs = dict(stereo_fusion=cfg.stereo_fusion, rv_pos=cfg.rv_pos,
                               vopts=vopts)
        elif cfg.process_method == 2:
            self.process = pipeline.process_2
            self.kwargs = dict(stereo_fusion=cfg.stereo_fusion,
                               temporal_fusion=cfg.temporal_fusion,
                               num_intervals=cfg.num_intervals, rv_pos=cfg.rv_pos,
                               vopts=vopts)
        else:
            raise ValueError(f"process_method {cfg.process_method} is not benchmarked")

    def chunks(self, wrapped: Callable):
        """run_full_seq over the segment, pass after pass."""
        from dvs_mcemvs_torch import pipeline

        while True:
            n = 0
            for item in pipeline.run_full_seq(self.mappers, self.events, self.trajs,
                                              self.fopts, wrapped, **self.kwargs):
                n += 1
                yield item
            if n == 0:
                raise RuntimeError("no chunk of the segment could be computed")

    def extract(self, res) -> List[tuple]:
        """The CLI's save step without the files: each saved depth map's
        extraction and its depth, confidence and mask copied to the host."""
        from dvs_mcemvs_torch import mapper

        dsis = [res.fused_dsi]
        if "camera_time" in res.dsis:
            dsis.append(res.dsis["camera_time"])
        out = []
        for d in dsis:
            dm = mapper.get_depth_map(self.mappers[0], d, self.opts)
            out.append((dm.depth.cpu().numpy(), dm.confidence.cpu().numpy(),
                        dm.mask.cpu().numpy()))
        return out

    def close(self) -> None:
        from dvs_mcemvs_torch import mapper, pipeline

        mapper.clear_programs()
        pipeline.clear_programs()


class Record:
    """One chunk: its window, its times (host clock) and, if judged, what
    the timed path produced."""

    __slots__ = ("ordinal", "k", "ts", "t_req", "t_wrap", "t_enter", "t_exit", "t_save",
                 "t_done", "failed", "res", "maps", "keep")

    def __init__(self, ordinal: int, t_req: float):
        self.ordinal, self.t_req = ordinal, t_req
        self.t_wrap = time.perf_counter()
        self.k = self.ts = self.t_enter = self.t_exit = self.t_save = self.t_done = None
        self.failed, self.res, self.maps, self.keep = False, None, None, False


class Driver:
    """Feeds chunks through the program: the main thread runs the
    scheduler and the process function, the save pool extracts and copies.
    In a traced run each span ends in a device sync."""

    def __init__(self, prog: Program, traced: bool, device):
        from dvs_mcemvs_torch.utils.writers import SaveWorkerPool

        self.prog, self.traced, self.device = prog, traced, device
        self.pool = SaveWorkerPool(workers=prog.cfg.save_workers)
        self.records: List[Record] = []
        self._n = 0
        self._t_req = 0.0
        self._last: Optional[Record] = None
        self._it = prog.chunks(self._wrapped)
        # Host spans in the profile of a traced run's profiled stretch
        # (torch.profiler.record_function there).
        self._span: Callable = contextlib.nullcontext

    def _sync(self) -> None:
        if self.traced and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _wrapped(self, mps, evs, trs, ts, **kw):
        rec = Record(self._n, self._t_req)
        self._n += 1
        self.records.append(rec)
        self._last = rec
        rec.t_enter = time.perf_counter()
        try:
            with self._span("process"):
                res = self.prog.process(mps, evs, trs, ts, **kw)
                self._sync()
        except ValueError:
            rec.failed = True
            raise
        finally:
            rec.t_exit = time.perf_counter()
            self._t_req = rec.t_exit
        return res

    def _save(self, rec: Record, res) -> None:
        rec.t_save = time.perf_counter()
        with self._span("extract"):
            maps = self.prog.extract(res)
        rec.t_done = time.perf_counter()
        if rec.keep:
            rec.maps = maps

    def step(self, keep: bool = False) -> Record:
        """Compute the next chunk and hand it to the save pool."""
        self._t_req = time.perf_counter()
        k, ts, res = next(self._it)
        rec = self._last
        rec.k, rec.ts, rec.keep = k, ts, keep
        if keep:
            rec.res = res
        self.pool.submit(self._save, rec, res)
        return rec

    def drain(self) -> None:
        self.pool.drain()

    def close(self) -> None:
        self.pool.shutdown()


# ---------------------------------------------------------------------------
# The reference's side
# ---------------------------------------------------------------------------

# The upstream defaults of the flags a preset may leave out (EMVS's options;
# the reference reads them here, not from the program).
REFERENCE_DEFAULTS = {"packet_size": "1024", "adaptive_threshold_kernel_size": "5",
                      "adaptive_threshold_c": "5", "median_filter_size": "5",
                      "max_confidence": "0", "depth_sampling": "linear",
                      "forward_looking": "false", "process_method": "1",
                      "num_intervals": "4", "stereo_fusion": "2", "temporal_fusion": "4",
                      "dimX": "0", "dimY": "0", "fov_deg": "0"}


class Reference:
    """The plain reference over the same raw inputs as the program."""

    def __init__(self, config: dict, streams, poses):
        f = dict(REFERENCE_DEFAULTS, **traffic.flags(config))
        if f["stereo_fusion"] != "2" or (f["process_method"] == "2"
                                         and f["temporal_fusion"] != "4"):
            raise ValueError("the reference fuses by the harmonic mean across cameras and "
                             "the arithmetic mean over time only")
        rig = config["rig"]
        self.depths = emvs.plane_depths(f["depth_sampling"], float(f["min_depth"]),
                                        float(f["max_depth"]), int(f["dimZ"]))
        rig_cams = traffic.cameras(rig)
        self.sensors = [emvs.Camera(*c["K"], c["distortion"], tuple(c["D"]),
                                    None if c["R"] is None else tuple(c["R"].ravel()))
                        for c in rig_cams]
        # The DSI's virtual camera (upstream's setupDSI): P's fx on both axes,
        # or the focal length of `fov_deg` where it is 10 degrees or more.
        P = traffic.projection(rig)
        dim_x = int(f["dimX"]) or rig_cams[0]["width"]
        dim_y = int(f["dimY"]) or rig_cams[0]["height"]
        fov = float(f["fov_deg"])
        focal = P[0] if fov < 10 else 0.5 * dim_x / np.tan(0.5 * np.deg2rad(fov))
        self.geo = emvs.Geometry(dim_x, dim_y, focal, P[2], P[3], self.depths,
                                 int(f["packet_size"]))
        cam0 = emvs.Poses.from_arrays(*poses)
        T_he = traffic.hand_eye(rig)
        if T_he is not None:
            cam0 = cam0.moved(T_he)
        self.cams = [cam0] + [cam0.moved(traffic.rigid_inverse(c["T_i_0"]))
                              for c in rig_cams[1:]]
        self.streams = streams
        self.method, self.intervals = int(f["process_method"]), int(f["num_intervals"])
        self.xo = emvs.ExtractOptions(int(f["adaptive_threshold_kernel_size"]),
                                      float(f["adaptive_threshold_c"]),
                                      int(f["median_filter_size"]), float(f["max_confidence"]))
        start, stop, duration, out_skip = traffic.segment(config)
        self.chunks = emvs.chunk_times(start, stop, duration, out_skip,
                                       f["forward_looking"].lower() in ("true", "1"))

    def outputs(self, k: int, device, dtype=torch.float32) -> dict:
        return emvs.run_chunk(self.geo, self.sensors, self.streams, self.cams, self.chunks[k],
                              self.method, self.intervals, self.xo, device, dtype)


def program_outputs(rec: Record) -> dict:
    """What the timed path produced for a judged chunk, by stage."""
    res = rec.res
    maps = [dict(depth=d, confidence=c, mask=m) for d, c, m in rec.maps]
    if "camera0" in res.dsis:
        n = sum(k.startswith("camera") and k[6:].isdigit() for k in res.dsis)
        cams = [res.dsis[f"camera{i}"] for i in range(n)]
        dsis = [res.fused_dsi]
    else:
        cams = [res.dsis["left_temporal"], res.dsis["right_temporal"]]
        dsis = [res.fused_dsi, res.dsis["camera_time"]]
    return {"cams": cams, "extractions": list(zip(dsis, maps))}


def as_program(ref: dict) -> dict:
    """Reference outputs in the program's place (the control): its maps as
    host arrays, as the program's come."""
    def host(m):
        return {k: v.float().cpu().numpy() for k, v in m.items()}

    return {"cams": ref["cams"], "extractions": [(d, host(m)) for d, m in ref["extractions"]]}


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------


def nvidia_smi(fields: str) -> str:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def completed(recs: List[Record], end: float) -> List[Record]:
    """The chunks whose maps were on the host by `end`."""
    return [r for r in recs if not r.failed and r.t_done is not None and r.t_done <= end]


@dataclasses.dataclass
class Outcome:
    result: dict
    rows: List[Dict[str, float]]
    judged: List[Record]
    reference: Optional[Reference]
    refs: List[dict]
    trace: Optional[dict]


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: Optional[float] = None, log: Callable[[str], None] = print,
        keep_refs: bool = False) -> Outcome:
    """One run of `cell`; returns the result line's object and what was
    judged."""
    from benchmark import profiling

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.empty(1, device=device)       # the allocator, before its statistics
        torch.cuda.reset_peak_memory_stats(device)
    mix = cell.mix
    log(f"device ready: {time.perf_counter() - t_start:.3f} s after start")
    streams = traffic.generate(cell.config, mix, seed, device)
    poses = traffic.pose_arrays(cell.config)
    log(f"inputs: {[s[0].shape[0] for s in streams]} events, {time.perf_counter() - t_start:.3f}"
        f" s after start")
    prog = Program(cell.config, streams, poses, device)
    log(f"program: backend {prog.backend}, {prog.process.__name__}")
    drv = Driver(prog, trace, device)
    try:
        outcome = _drive(cell, drv, prog, seed, seconds, trace, device, t_start, log,
                         profiling)
    finally:
        drv.close()
    result, judged = outcome
    trace_data = result.pop("_trace")
    # The program's state is freed before the reference runs.
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    prog.close()
    del prog, drv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    result["device"]["memory_peak_bytes"] = int(peak)
    ref = Reference(cell.config, streams, poses)
    rows, refs = [], []
    t_ref = time.perf_counter()
    for rec in judged:
        r = ref.outputs(rec.k, device)
        rows.append(judge.numbers(program_outputs(rec), r, ref.depths))
        if keep_refs:
            refs.append(r)
        log(f"judged chunk {rec.ordinal} (window {rec.k}): "
            + ", ".join(f"{k} {v:.6g}" for k, v in rows[-1].items()))
    log(f"reference: {len(judged)} chunks in {time.perf_counter() - t_ref:.3f} s")
    worst = judge.worst(rows)
    result["correct"] = len(rows) > 0 and judge.verdict(worst, cell.limits)
    if trace:
        per_layer = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"])(trace_data)
            if v is not None:
                per_layer[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = per_layer
    result["check"] = judge.check_lines(worst, cell.limits)
    return Outcome(result, rows, judged, ref, refs, trace_data)


def _warm_workers(drv: Driver, res, workers: int) -> None:
    """Capture the extraction programs on every save worker: one task a
    worker, held at a barrier until all have started."""
    barrier = threading.Barrier(workers)

    def task():
        barrier.wait(timeout=120)
        drv.prog.extract(res)

    for _ in range(workers):
        drv.pool.submit(task)
    drv.drain()


def _drive(cell, drv: Driver, prog: Program, seed, seconds, trace, device, t_start, log,
           profiling):
    cuda = device.type == "cuda"
    mix = cell.mix
    from dvs_mcemvs_torch import pipeline

    # Spans end in a device sync only from the window on: a sync while a save
    # worker captures its extraction program would break the capture.
    drv.traced = False

    n_windows = sum(1 for _ in pipeline.full_seq_windows(prog.fopts))
    # Warm-up: one pass over the segment, then every save worker.
    for i in range(n_windows):
        last = drv.step(keep=i == n_windows - 1)
    drv.drain()
    if prog.cfg.save_workers > 0:
        _warm_workers(drv, last.res, prog.cfg.save_workers)
    last.res = last.maps = None
    if cuda:
        torch.cuda.synchronize(device)
    drv.records.clear()
    log(f"warm-up: {n_windows} windows, {time.perf_counter() - t_start:.3f} s after start")
    smi = "clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"
    smi_before = nvidia_smi(smi) if cuda else ""

    rng = random.Random(seed)
    R = JUDGED_CHUNKS
    sample: List[Record] = []

    def pick(j: int):
        slot = j if j < R else rng.randrange(j + 1)
        return slot if slot < R else None

    def keep_in_sample(slot, rec):
        if slot < len(sample):
            old = sample[slot]
            old.keep, old.res, old.maps = False, None, None
            sample[slot] = rec
        else:
            sample.append(rec)

    drv.traced = trace
    # The set-up's objects out of the collector's way for the window.
    gc.collect()
    gc.freeze()
    T0 = time.perf_counter()
    setup_s = T0 - t_start
    end = T0 + seconds
    j = 0
    while time.perf_counter() < end:
        slot = pick(j)
        rec = drv.step(keep=slot is not None)
        if slot is not None:
            keep_in_sample(slot, rec)
        j += 1
    t_closed = time.perf_counter()
    drv.drain()
    t_drained = time.perf_counter()
    gc.unfreeze()
    smi_after = nvidia_smi(smi) if cuda else ""
    recs = list(drv.records)
    failed = sum(r.failed for r in recs)
    per_chunk = len(prog.mappers) * int(mix["events_per_window"]) * prog.cfg.out_skip \
        / prog.cfg.duration
    done = completed(recs, end)
    metrics_e2e = {"setup_s": setup_s,
                   "replay_mev_s": len(done) * per_chunk / seconds / 1e6}
    notes = {"chunks_done": len(done), "chunks_started": len(recs),
             "chunk_events": per_chunk,
             "realtime_factor": len(done) * prog.cfg.out_skip / seconds}
    notes.update({"window_s": seconds, "closed_after_s": t_closed - T0,
                  "drained_after_s": t_drained - T0, "nvidia_smi_before": smi_before,
                  "nvidia_smi_after": smi_after, "backend": prog.backend})
    log("window: " + json.dumps(notes))
    trace_data = None
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": 1,
                "power_limit": nvidia_smi("power.limit") if cuda else ""}
    if trace:
        spans = {"window": [(r.t_wrap - r.t_req) * 1e3 for r in recs if r.t_enter is not None],
                 "process": [(r.t_exit - r.t_enter) * 1e3 for r in recs
                             if r.t_exit is not None and not r.failed],
                 "extract": [(r.t_done - r.t_save) * 1e3 for r in recs
                             if r.t_done is not None]}
        prof = profiling.profile_stretch(drv, PROFILED_CHUNKS, device)
        trace_data = {"spans": spans, "profile": prof, "cell": cell.name}
        if prof is not None:
            dev_info["busy_s"] = prof["busy_s"]
            dev_info["window_s"] = prof["window_s"]
    wanted = {m["name"] for m in cell.end_to_end}
    missing = wanted - set(metrics_e2e)
    if missing:
        raise ValueError(f"{cell.name}: the harness reads no {sorted(missing)}")
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    result = {"correct": False, "attempted": len(recs), "failed": failed,
              "metrics": {k: {"value": metrics_e2e[k], "unit": units[k]} for k in wanted},
              "device": dev_info, "_trace": trace_data, "notes": notes}
    if trace and trace_data["profile"] is not None:
        result["breakdown"] = {"device_ops": trace_data["profile"]["device_ops"],
                               "idle_gaps": trace_data["profile"]["idle_gaps"]}
    for r in recs:
        if r not in sample:
            r.res = r.maps = None
    return result, [r for r in sample if r.res is not None and r.maps is not None]
