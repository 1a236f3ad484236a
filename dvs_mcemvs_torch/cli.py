"""Command-line entry point -- the `run_emvs` equivalent, on PyTorch and the card.

Port of dvs_mcemvs_tpu/cli.py: calibration dispatch, event/pose ingest,
trajectory chaining through hand-eye and extrinsics, process selection
(1/2/5), single-shot vs sliding-window scheduling with checkpoint resume,
the native event store and the save worker pool, and the same artifacts,
on one card or on a mesh of ranks.  Accepts the reference's own
`--flagfile=<x>.conf` presets.

    python -m dvs_mcemvs_torch.cli --flagfile configs/example.conf
    python -m dvs_mcemvs_torch.cli --flagfile ... --platform=cpu   # the CPU
    python -m dvs_mcemvs_torch.cli --flagfile ... --num_devices=4  # 4 ranks
    python -m dvs_mcemvs_torch.cli --flagfile ... --coordinator=host0:29500 \
        --num_processes=2 --process_id=$P                          # each process

`--platform` '' or 'cuda' runs on the card and raises without one; 'cpu'
runs on the CPU.  `--num_devices` N > 1 spawns N ranks on this host, one a
card (gloo ranks on the CPU; 0 = every card, 1 on the CPU), each holding
the whole chunk and voting its shard of the mesh.  `--coordinator`,
`--num_processes` and `--process_id` make this process one rank of a
multi-process run (missing values from MASTER_ADDR/MASTER_PORT, WORLD_SIZE,
RANK), on the card at index process_id modulo the cards present, feeding
only its slice of each chunk.  Rank 0's artifacts are the run's; the other
ranks write into scratch directories that are removed at the end.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import sys
import tempfile
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from . import pipeline
from .config import RunConfig, config_to_flagfile, parse_args
from .device import require_cuda
from .io import calib as calibmod, events as eventsmod, outputs, poses as posesmod
from .io.events import TimeOrigin
from .mapper import (DsiShape, Events, Mapper, PointCloudOptions, get_depth_map,
                     get_pointcloud, make_mapper)
from .ops import extract, pointcloud as pcops, se3, trajectory as trajmod
from .ops.se3 import SE3

log = logging.getLogger("dvs_mcemvs_torch")


def resolve_device(platform: str, index: int = 0) -> torch.device:
    """The device `--platform` names: '' or 'cuda' the card at `index`
    (raising when there is none), 'cpu' the CPU."""
    if platform in ("", "cuda"):
        require_cuda()
        return torch.device("cuda", index)
    if platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"--platform must be '', 'cuda' or 'cpu', got {platform!r}")


def resolve_num_devices(n: int, device: torch.device) -> int:
    """The ranks `--num_devices` = `n` asks for on this host: 0 means every
    card (1 on the CPU); more than the cards present raises."""
    if n < 0:
        raise ValueError(f"--num_devices must be >= 0, got {n}")
    if device.type == "cpu":
        return n or 1
    cards = torch.cuda.device_count()
    if n > cards:
        raise ValueError(f"--num_devices={n}, but {cards} card(s) are present")
    return n or cards


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place in a run of more than one rank.  `per_process`:
    each rank feeds only its own slice of a chunk (the multi-process
    launch); else every rank holds the whole chunk (`--num_devices`)."""

    rank: int
    world: int
    per_process: bool


def _se3_from_mat(T: np.ndarray, device) -> SE3:
    return se3.from_matrix(torch.as_tensor(np.asarray(T, np.float32), device=device))


def _build_trajectories(
    poses: trajmod.Trajectory, rig: calibmod.RigCalibration, n_cams: int
) -> List[trajmod.Trajectory]:
    """traj_i = poses o T_hand_eye o T_i_0^-1, on the poses' device."""
    T_he = _se3_from_mat(rig.T_hand_eye, poses.device)
    traj0 = trajmod.apply_right(poses, T_he)
    trajs = [traj0]
    for i in range(1, n_cams):
        T_i0 = _se3_from_mat(rig.extrinsics(i), poses.device)
        trajs.append(trajmod.apply_right(traj0, se3.inverse(T_i0)))
    return trajs


def _extract_and_save(
    mapper: Mapper, dsi, cfg: RunConfig, suffix: str, prefix: str,
    opts: extract.DepthMapOptions, precomputed=None,
):
    res = precomputed if precomputed is not None else get_depth_map(mapper, dsi, opts)
    outputs.save_depth_maps(
        res.depth.cpu().numpy(), res.confidence.cpu().numpy(), res.mask.cpu().numpy(),
        cfg.min_depth, cfg.max_depth, suffix, prefix)
    if cfg.save_dense:
        dense = extract.densify_host(res, mapper.depth_vec)
        outputs.save_dense_depth_png(prefix + f"depth_map_dense_{suffix}.png",
                                     dense, cfg.min_depth, cfg.max_depth)
    if cfg.save_conf_stats:
        cmin, cmax = extract.confidence_range_stats(res.confidence)
        outputs.save_conf_stats(
            os.path.join(cfg.out_path, f"conf_range_{suffix}.txt"),
            float(cmin), float(cmax))
    return res


def auto_spec(cfg: RunConfig, trajs, events, mapper: Mapper) -> str:
    """The kernel-engine spec for this run: the group size bounded by the
    rig's travel over one chunk (`voting_hist.auto_backend_spec`, as the
    JAX package's CLI selects on its kernel engine).  The travel is read
    from the trajectory on the host."""
    from .ops.voting_hist import auto_backend_spec

    def count(src) -> int:
        if isinstance(src, Events):
            return src.num
        return src.window_count(cfg.start_time_s, cfg.stop_time_s)

    pos = trajs[0].poses.t.cpu().numpy()
    ts = trajs[0].ts.cpu().numpy()
    span = cfg.duration if cfg.full_seq else (cfg.stop_time_s - cfg.start_time_s)
    total_t = float(ts[-1] - ts[0])
    # The default window [0, 1000 s] far exceeds any real recording; the
    # rig can't travel outside the trajectory's actual extent.
    span = min(span, total_t) if total_t > 0 else span
    travel = float(np.linalg.norm(np.diff(pos, axis=0), axis=1).sum())
    chunk_travel = travel * (span / total_t if total_t > 0 else 1.0)
    n_min = min(count(s) for s in events)
    if cfg.full_seq:
        # Group size follows a CHUNK's packet count, not the whole range's.
        whole = cfg.stop_time_s - cfg.start_time_s
        if total_t > 0:
            whole = min(whole, total_t)
        n_min = max(1, int(n_min * (span / max(whole, span))))
    n_pk = max(1, n_min // cfg.packet_size)
    spec = auto_backend_spec(chunk_travel, n_pk, float(mapper.vcam.fx),
                             cfg.min_depth, cfg.max_depth, cfg.dimZ)
    log.info("auto backend: %s (chunk travel %.3f m, %d packets)", spec,
             chunk_travel, n_pk)
    return spec


class _MeshFeed:
    """The mesh of a multi-rank run and how a chunk's events reach it: under
    `--num_devices` every rank pads the whole chunk and takes its event
    shard; in a multi-process run each rank takes a quantum-aligned slice
    of every camera's chunk (the sub-quantum tail, under world x quantum
    events, is dropped, as the reference drops its last partial packet)."""

    def __init__(self, cfg: RunConfig, backend: str, device: torch.device, ranks: Ranks):
        from .parallel import mesh as meshmod

        if ranks.per_process:
            self.mesh = meshmod.global_mesh(cfg.dimZ, backend=backend, device=device)
        else:
            self.mesh = meshmod.make_mesh(
                *meshmod.pick_mesh_shape(ranks.world, cfg.dimZ, backend=backend), device)
        n_event = self.mesh.size(0)
        self.cfg, self.ranks, self.device = cfg, ranks, device
        self.quantum = (n_event // ranks.world if ranks.per_process else n_event) \
            * cfg.packet_size
        log.info("rank %d of %d: mesh (event=%d, plane=%d), backend %s, %s", ranks.rank,
                 ranks.world, n_event, self.mesh.size(1), backend,
                 "each rank feeds its slice" if ranks.per_process else "shards of the chunk")

    def inputs(self, mappers, events, trajs, T_rv_w, tables):
        """(this rank's step arguments, events voted by all ranks), or None
        when a camera's chunk is too small.  `tables` are the step's
        `sharded.device_step_tables`, built once a run."""
        from .mapper import bucket_capacity
        from .parallel import sharded as shardedmod

        packet, quantum, ranks = self.cfg.packet_size, self.quantum, self.ranks
        if not ranks.per_process:
            if min(e.num for e in events) <= packet:
                return None
            cap = bucket_capacity(max(e.num for e in events), quantum)
            args = shardedmod.sharded_step_inputs(mappers, events, trajs, T_rv_w,
                                                  self.mesh.size(0), packet, capacity=cap,
                                                  tables=tables)
            return shardedmod.local_inputs(self.mesh, args), sum(e.num for e in events)
        if min(e.num for e in events) < ranks.world * quantum:
            return None
        local = []
        for ev in events:
            per = (ev.num // (ranks.world * quantum)) * quantum
            local.append(ev.slice(ranks.rank * per, (ranks.rank + 1) * per))
        # Slices are equal-sized by construction, so the capacity needs no
        # all-gather.
        cap = bucket_capacity(max(e.num for e in local), quantum)
        args = shardedmod.sharded_step_inputs_multihost(
            self.mesh, mappers, local, trajs, T_rv_w, packet, local_capacity=cap,
            tables=tables)
        return args, sum(e.num for e in local) * ranks.world


def _make_mesh_runner(cfg: RunConfig, mappers, trajs, opts, backend: str, feed: _MeshFeed):
    """process_1 on the mesh: warp, voting, event all-reduce, fusion, the
    collapse and the extraction in one sharded step, as a process callable
    taking a `sync` flag (wait for the device, so the time is the device's).
    The step's tables of the run's `mappers` and `trajs` are built here."""
    from .parallel import sharded as shardedmod

    tables = shardedmod.device_step_tables(mappers, trajs, feed.device)
    step = shardedmod.make_sharded_step(
        feed.mesh, shardedmod.rig_spec_from_mappers(mappers),
        shardedmod.ShardedStepConfig(fusion_method=cfg.stereo_fusion,
                                     packet_size=cfg.packet_size, backend=backend,
                                     plane_block=cfg.plane_block, extract_options=opts))

    def run_mesh(mps, evs, trs, ts, sync: bool) -> pipeline.ProcessResult:
        t0 = time.perf_counter()
        T_rv_w = pipeline.place_reference_view(trs[0], ts, cfg.rv_pos)
        fed = feed.inputs(mps, evs, trs, T_rv_w, tables)
        if fed is None:
            raise ValueError("chunk smaller than one packet (one quantum a rank)")
        args, n_ev = fed
        out = step(*args)
        if sync and out["depth"].device.type == "cuda":
            torch.cuda.synchronize(out["depth"].device)
        dt = time.perf_counter() - t0
        res = pipeline.ProcessResult(
            fused_dsi=shardedmod.gather_planes(feed.mesh, out["dsi"]), T_rv_w=T_rv_w, ts=ts,
            timings={"mesh_step_s": dt}, mev_per_s=(n_ev / dt / 1e6) if dt > 0 else None)
        res.extracted = extract.DepthMapResult(
            depth=out["depth"], confidence=out["confidence"], mask=out["mask"],
            depth_dense=None, depth_indices=out["depth_indices"])
        return res

    return run_mesh


def _make_mesh_pair_evaluator(cfg: RunConfig, mappers, trajs, backend: str,
                              feed: _MeshFeed):
    """process_2/5's `evaluate_pair` on the mesh: each sub-interval's two
    camera DSIs voted by the sharded voting step and gathered whole on
    every rank, so the temporal accumulators and the extraction run as on
    one card.  The step's tables of the first two cameras are built here."""
    from .parallel import sharded as shardedmod

    tables = shardedmod.device_step_tables(mappers[:2], trajs[:2], feed.device)
    step = shardedmod.make_sharded_voting_step(
        feed.mesh, shardedmod.rig_spec_from_mappers(mappers[:2]),
        shardedmod.ShardedStepConfig(fusion_method=cfg.stereo_fusion,
                                     packet_size=cfg.packet_size, backend=backend,
                                     plane_block=cfg.plane_block))

    def evaluate_pair(mps, evs, trs, T_rv_w):
        fed = feed.inputs(mps[:2], evs, trs[:2], T_rv_w, tables)
        if fed is None:
            return None, None
        out = shardedmod.gather_planes(feed.mesh, step(*fed[0]), dim=1)
        return out[0], out[1]

    return evaluate_pair


def _open_store_ranks(evstore, path: str, offset: float, origin):
    """Open the streaming .evs cache in a multi-rank run: rank 0 builds it
    next to the source while the others wait, then they open it (or build
    their own where the file system is not shared).  A failed build fails
    every rank; none falls back to RAM."""
    import torch.distributed as dist

    store, err = None, None
    if dist.get_rank() == 0:
        try:
            store = evstore.NormalizedStore(evstore.open_or_build_h5(path), offset, origin)
        except Exception as e:  # re-raised below, after the peers have heard of it
            err = e
    status = [None if err is None else f"{type(err).__name__}: {err}"]
    dist.broadcast_object_list(status, src=0)
    if err is not None:
        raise err
    if status[0] is not None:
        raise RuntimeError(f"rank 0 could not build the event store of {path}: {status[0]}")
    if store is None:
        store = evstore.NormalizedStore(evstore.open_or_build_h5(path), offset, origin)
    return store


def _device_rank(rank: int, world: int, coordinator: str, cfg: RunConfig) -> None:
    """One of `--num_devices`' ranks, in a spawned process."""
    from .parallel.mesh import init_distributed, shutdown_distributed

    logging.basicConfig(level=logging.INFO,
                        format=f"%(asctime)s rank{rank} %(name)s %(levelname)s %(message)s")
    device = resolve_device(cfg.platform, rank)
    if device.type == "cpu":
        # The ranks share the host's cores.
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    init_distributed(coordinator, world, rank, device)
    try:
        _run(cfg, device, Ranks(rank, world, per_process=False))
    finally:
        shutdown_distributed()


def run(cfg: RunConfig) -> int:
    """Run the CLI's configuration: on one device, as `--num_devices`
    spawned ranks, or as one rank of a multi-process run."""
    from .parallel.mesh import init_distributed, shutdown_distributed, spawn_ranks

    device = resolve_device(cfg.platform)
    if cfg.coordinator or cfg.num_processes > 0 or cfg.process_id >= 0:
        if cfg.num_devices > 1:
            log.info("--num_devices=%d is not read in a multi-process run: one rank a "
                     "process", cfg.num_devices)
        rank, world = init_distributed(
            cfg.coordinator or None, cfg.num_processes or None,
            cfg.process_id if cfg.process_id >= 0 else None,
            "cpu" if device.type == "cpu" else None)
        try:
            if device.type == "cuda":
                device = torch.device("cuda", torch.cuda.current_device())
            return _run(cfg, device, Ranks(rank, world, per_process=True) if world > 1
                        else None)
        finally:
            shutdown_distributed()
    n_dev = resolve_num_devices(cfg.num_devices, device)
    if n_dev > 1:
        log.info("spawning %d ranks (%s)", n_dev, device.type)
        spawn_ranks(_device_rank, n_dev, (cfg,))
        return 0
    return _run(cfg, device, None)


def _run(cfg: RunConfig, device: torch.device, ranks: Optional[Ranks]) -> int:
    """The run on `device`, as rank `ranks` of a mesh (None: alone)."""
    with contextlib.ExitStack() as scratch:
        if ranks is not None and ranks.rank != 0:
            # Every rank computes; rank 0's artifacts are the run's.
            cfg = dataclasses.replace(cfg, out_path=scratch.enter_context(
                tempfile.TemporaryDirectory(prefix=f"emvs_rank{ranks.rank}_")) + "/")
            log.info("rank %d: outputs go to the scratch directory %s", ranks.rank,
                     cfg.out_path)
        return _run_on(cfg, device, ranks)


def _run_on(cfg: RunConfig, device: torch.device, ranks: Optional[Ranks]) -> int:
    os.makedirs(cfg.out_path or ".", exist_ok=True)
    rig = calibmod.load_calibration(cfg.calib_type, cfg.calib_path, cfg.mocap_calib_path)

    if cfg.bag_filename:
        cfg.bag_filename_left = cfg.bag_filename
        cfg.bag_filename_right = cfg.bag_filename
        cfg.bag_filename_pose = cfg.bag_filename

    trinocular = bool(cfg.event_topic2) and rig.num_cameras >= 3
    n_cams = 3 if trinocular else 2

    origin = TimeOrigin()
    log.info("Loading poses from %s", cfg.bag_filename_pose)
    # Poses over the FULL time range, as the reference loads them even in
    # full_seq mode; event files are windowed.
    pose_traj = posesmod.read_poses(cfg.bag_filename_pose, topic=cfg.pose_topic,
                                    origin=origin, device=device)

    # full_seq over HDF5 inputs never materializes the stream: the .evs
    # cache next to the source is stream-built in O(chunk) memory and every
    # window is an mmap'd O(log E) lookup.  Other sources (a bag too) are
    # read into RAM.
    stream_ok = cfg.full_seq and cfg.use_event_store

    def _open_source(path: str, topic: str, offset: float):
        if stream_ok and os.path.splitext(path)[1].lower() in (".h5", ".hdf5"):
            from .io import evstore

            if ranks is not None:
                store = _open_store_ranks(evstore, path, offset, origin)
            else:
                store = evstore.NormalizedStore(evstore.open_or_build_h5(path), offset,
                                                origin)
            log.info("streaming event store for %s: %d events", path, store.count)
            return store
        window = dict(t_start=cfg.start_time_s, t_stop=cfg.stop_time_s, offset=offset,
                      origin=origin)
        if path.endswith(".bag"):
            return eventsmod.read_events_rosbag(path, topic, **window)
        return eventsmod.read_events(path, **window)

    log.info("Loading events")
    events = [_open_source(cfg.bag_filename_left, cfg.event_topic0, cfg.offset0),
              _open_source(cfg.bag_filename_right, cfg.event_topic1, cfg.offset1)]
    if trinocular:
        events.append(_open_source(cfg.bag_filename2 or cfg.bag_filename, cfg.event_topic2,
                                   cfg.offset2))
    log.info("Events: %s", [s.num if isinstance(s, Events)
                            else s.window_count(cfg.start_time_s, cfg.stop_time_s)
                            for s in events])

    trajs = _build_trajectories(pose_traj, rig, n_cams)
    shape = DsiShape(cfg.dimX, cfg.dimY, cfg.dimZ, cfg.fov_deg,
                     cfg.min_depth, cfg.max_depth)
    mappers = [make_mapper(rig.cams[i], shape, cfg.depth_sampling) for i in range(n_cams)]

    # Event-accumulation previews; stores contribute a bounded head slice.
    for i, src in enumerate(events):
        ev = src if isinstance(src, Events) else src.head(
            1_000_000, cfg.start_time_s, cfg.stop_time_s)
        outputs.save_events_png(os.path.join(cfg.out_path, f"events_{i}.png"), ev,
                                rig.cams[i].width, rig.cams[i].height)

    opts = extract.DepthMapOptions(
        adaptive_threshold_kernel_size=cfg.adaptive_threshold_kernel_size,
        adaptive_threshold_c=cfg.adaptive_threshold_c,
        median_filter_size=cfg.median_filter_size,
        full_sequence=cfg.full_seq,
        save_conf_stats=cfg.save_conf_stats,
        max_confidence=cfg.max_confidence,
        rv_pos=cfg.rv_pos,
        collapse_method=cfg.collapse_method,
    )
    backend = cfg.splat_backend
    if backend == "auto":
        backend = auto_spec(cfg, trajs, events, mappers[0])
    vopts = pipeline.VotingOptions(packet_size=cfg.packet_size, backend=backend,
                                   plane_block=cfg.plane_block)

    # On a mesh, process_1 runs the sharded step and process_2/5 vote each
    # sub-interval on the sharded voting step (parallel/sharded.py).
    mesh_runner = mesh_pairs = None
    if ranks is not None:
        feed = _MeshFeed(cfg, backend, device, ranks)
        if cfg.process_method == 1:
            mesh_runner = _make_mesh_runner(cfg, mappers, trajs, opts, backend, feed)
        else:
            mesh_pairs = _make_mesh_pair_evaluator(cfg, mappers, trajs, backend, feed)

    n_calls = 0

    def run_process(mps, evs, trs, ts):
        # Every `--timing_sync_every`-th chunk (the first included) waits for
        # the device, so its logged Mev/s is the device's, not the enqueue's.
        nonlocal n_calls
        every = cfg.timing_sync_every
        sync_now = every > 0 and n_calls % every == 0
        n_calls += 1
        v = dataclasses.replace(vopts, sync=True) if sync_now else vopts
        res = _process(mps, evs, trs, ts, v)
        log.info("chunk @ ts=%.3f: %.3f Mev/s %s", ts, res.mev_per_s or 0.0,
                 "device-true" if sync_now else "enqueued (the device overlaps)")
        return res

    def _process(mps, evs, trs, ts, vopts):
        if mesh_runner is not None:
            return mesh_runner(mps, evs, trs, ts, vopts.sync)
        if cfg.process_method == 1:
            return pipeline.process_1(mps, evs, trs, ts, cfg.stereo_fusion,
                                      rv_pos=cfg.rv_pos, vopts=vopts)
        if cfg.process_method not in (2, 5):
            raise ValueError(f"process_method must be 1, 2 or 5, got {cfg.process_method}")
        on_sub = None
        if not cfg.full_seq:
            # Per-sub-interval depth maps of both cameras, suffixes
            # 0_{k:03d} / 1_{k:03d} under the run's timestamp prefix.
            prefix = outputs.timestamp_prefix(cfg.out_path, ts)

            def on_sub(k, dsis):
                for c in range(2):
                    _extract_and_save(mps[0], dsis[f"camera{c}"], cfg, f"{c}_{k:03d}",
                                      prefix, opts)

        fn = pipeline.process_2 if cfg.process_method == 2 else pipeline.process_5
        return fn(mps[:2], evs[:2], trs[:2], ts, stereo_fusion=cfg.stereo_fusion,
                  temporal_fusion=cfg.temporal_fusion, num_intervals=cfg.num_intervals,
                  rv_pos=cfg.rv_pos, vopts=vopts, on_subinterval=on_sub,
                  evaluate_pair=mesh_pairs)

    flag_text = config_to_flagfile(cfg)
    with open(os.path.join(cfg.out_path, "run_flags.conf"), "w") as f:
        f.write(flag_text)

    with _profiler(cfg.profile_dir, device):
        return _run_configured(cfg, mappers, events, trajs, opts, run_process, flag_text)


@contextlib.contextmanager
def _profiler(profile_dir: str, device: torch.device):
    """A torch.profiler trace of the run (host, and the card's kernels when
    it runs there), written as a chrome trace into `profile_dir` on the way
    out, errors included."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        log.info("torch.profiler trace written to %s", path)


def _run_configured(cfg, mappers, events, trajs, opts, run_process, flag_text) -> int:
    if cfg.full_seq:
        return _run_full_seq(cfg, mappers, events, trajs, opts, run_process, flag_text)

    ts = cfg.resolved_ts()
    res = run_process(mappers, events, trajs, ts)
    prefix = outputs.timestamp_prefix(cfg.out_path, ts)

    dm = _extract_and_save(mappers[0], res.fused_dsi, cfg, "fused", prefix, opts,
                           precomputed=res.extracted)
    if cfg.process_method in (2, 5):
        # The reference's artifact set of the temporal algorithms: per-camera
        # temporal fusions, the camera-then-time map under its reference
        # name, and the converse time-then-camera order.
        tf = cfg.temporal_fusion
        _extract_and_save(mappers[0], res.dsis["left_temporal"], cfg,
                          f"left_temporal_{tf}", prefix, opts)
        _extract_and_save(mappers[0], res.dsis["right_temporal"], cfg,
                          f"right_temporal_{tf}", prefix, opts)
        _extract_and_save(mappers[0], res.fused_dsi, cfg, f"stereo_temporal_{tf}", prefix,
                          opts, precomputed=res.extracted)
        _extract_and_save(mappers[0], res.dsis["camera_time"], cfg,
                          f"stereo_temporal_camera_time{tf}", prefix, opts)
    if cfg.save_dsi:
        outputs.write_dsi_npy(os.path.join(cfg.out_path, "dsi_fused.npy"),
                              res.fused_dsi.cpu().numpy())
        ref_names = {"left_temporal": "fused_0_temporalfusion",
                     "right_temporal": "fused_1_temporalfusion",
                     "camera_time": "stereo_temporalfusion_camera_time"}
        for name, d in res.dsis.items():
            outputs.write_dsi_npy(
                os.path.join(cfg.out_path, f"dsi_{ref_names.get(name, name)}.npy"),
                d.cpu().numpy())
        if cfg.process_method in (2, 5):
            outputs.write_dsi_npy(os.path.join(cfg.out_path, "dsi_stereo_temporalfusion.npy"),
                                  res.fused_dsi.cpu().numpy())
    if cfg.save_mono:
        for name, d in res.dsis.items():
            if name.startswith("camera"):
                _extract_and_save(mappers[0], d, cfg, name, prefix, opts)

    if cfg.save_pointcloud:
        pc_opts = PointCloudOptions(cfg.radius_search, cfg.min_num_neighbors)
        pc = get_pointcloud(mappers[0], dm.depth, dm.mask, pc_opts)
        pcops.save_pcd(os.path.join(cfg.out_path, "pointcloud.pcd"), pc)
        log.info("point cloud: %d points", pc.xyz.shape[0])
        if cfg.late_fusion:
            # Per-camera depth -> point cloud -> concatenation.
            clouds = []
            for name, d in res.dsis.items():
                if not name.startswith("camera"):
                    continue
                r = get_depth_map(mappers[0], d, opts)
                clouds.append(get_pointcloud(mappers[0], r.depth, r.mask, pc_opts))
            if clouds:
                merged = pcops.PointCloud(np.concatenate([c.xyz for c in clouds]),
                                          np.concatenate([c.intensity for c in clouds]))
                pcops.save_pcd(os.path.join(cfg.out_path, "pointcloud_late_fused.pcd"),
                               merged)
    return 0


def _run_full_seq(cfg, mappers, events, trajs, opts, run_process, flag_text) -> int:
    from .checkpoint import RunCheckpoint, config_fingerprint, sync_multihost

    fopts = pipeline.FullSeqOptions(
        start_time=cfg.start_time_s, stop_time=cfg.stop_time_s,
        duration=cfg.duration, out_skip=cfg.out_skip,
        forward_looking=cfg.forward_looking)
    # The skip predicate rides into the scheduler, so a resumed chunk never
    # reaches process(): resume saves the voting, not only the writes.
    ckpt = RunCheckpoint(os.path.join(cfg.out_path, "checkpoint.json"),
                         fingerprint=config_fingerprint(flag_text), enabled=cfg.checkpoint)
    # Every rank skips the chunks rank 0's ledger holds, or the sharded
    # step's per-chunk collectives would pair up wrongly.
    sync_multihost(ckpt)
    if all(not isinstance(s, Events) for s in events):
        # Streaming ingest already produced stores.
        runner = pipeline.run_full_seq_stores(mappers, events, trajs, fopts, run_process,
                                              skip=ckpt.is_done)
        log.info("full_seq: streaming event stores + prefetch")
    else:
        events = [s if isinstance(s, Events) else s.window(cfg.start_time_s, cfg.stop_time_s)
                  for s in events]
        if cfg.use_event_store:
            # The store is asked for: a failure to build or open it fails
            # the run rather than falling back to RAM.
            from .io import evstore

            stores = []
            for i, ev in enumerate(events):
                path = os.path.join(cfg.out_path, f".events_{i}.evs")
                evstore.write_store(path, ev)
                stores.append(evstore.EventStore(path))
            runner = pipeline.run_full_seq_stores(mappers, stores, trajs, fopts,
                                                  run_process, skip=ckpt.is_done)
            log.info("full_seq: native event store + prefetch enabled")
        else:
            runner = pipeline.run_full_seq(mappers, events, trajs, fopts, run_process,
                                           skip=ckpt.is_done)
    n_chunks = 0
    ckpt_lock = threading.Lock()

    def save_chunk(k: int, ts: float, res) -> None:
        nonlocal n_chunks
        prefix = outputs.timestamp_prefix(cfg.out_path, ts)
        _extract_and_save(mappers[0], res.fused_dsi, cfg, "fused", prefix, opts,
                          precomputed=res.extracted)
        # The temporal algorithms also write the converse-order map of
        # every chunk (their per-camera maps are skipped in full_seq mode).
        if "camera_time" in res.dsis:
            _extract_and_save(mappers[0], res.dsis["camera_time"], cfg,
                              f"stereo_temporal_camera_time{cfg.temporal_fusion}",
                              prefix, opts)
        if cfg.save_dsi:
            outputs.write_dsi_npy(prefix + "dsi_fused.npy", res.fused_dsi.cpu().numpy())
        # mark_done mutates the ledger and replaces its file, and saves run
        # on pool workers.
        with ckpt_lock:
            ckpt.mark_done(k, ts)
            n_chunks += 1
        log.info("chunk %d @ ts=%.3f done", k, ts)

    # Chunk saves (extraction, device-to-host copies, PNG and point-list
    # writes) run on `--save_workers` threads with bounded depth, all on the
    # default stream; save_workers=0 saves each chunk before the next runs.
    if cfg.save_workers > 0:
        from .utils.writers import SaveWorkerPool

        with SaveWorkerPool(workers=cfg.save_workers) as pool:
            for item in runner:
                pool.submit(save_chunk, *item)
    else:
        for item in runner:
            save_chunk(*item)
    log.info("full_seq: %d chunks written (%d total complete)", n_chunks,
             ckpt.num_done or n_chunks)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    cfg = parse_args(argv if argv is not None else sys.argv[1:])
    return run(cfg)


if __name__ == "__main__":
    sys.exit(main())
