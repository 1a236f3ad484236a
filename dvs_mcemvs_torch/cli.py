"""Command-line entry point -- the `run_emvs` equivalent, on PyTorch and the card.

Port of dvs_mcemvs_tpu/cli.py for one process and one card: calibration
dispatch, event/pose ingest, trajectory chaining through hand-eye and
extrinsics, process selection (1/2/5), single-shot vs sliding-window
scheduling with checkpoint resume, the native event store and the save
worker pool, and the same artifacts.  Accepts the reference's own
`--flagfile=<x>.conf` presets.

    python -m dvs_mcemvs_torch.cli --flagfile configs/example.conf
    python -m dvs_mcemvs_torch.cli --flagfile ... --platform=cpu   # the CPU

`--platform` '' or 'cuda' runs on the card and raises without one; 'cpu'
runs on the CPU.  More than one device or process is not ported and is
refused with a ValueError that names its ROADMAP item (Queue 1 item 6).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import sys
import threading
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


def resolve_device(platform: str) -> torch.device:
    """The device `--platform` names: '' or 'cuda' the card (raising when
    there is none), 'cpu' the CPU."""
    if platform in ("", "cuda"):
        return require_cuda()
    if platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"--platform must be '', 'cuda' or 'cpu', got {platform!r}")


def check_ported(cfg: RunConfig) -> None:
    """Raise on a configuration the port does not run, naming its ROADMAP
    item; nothing degrades quietly."""
    if cfg.num_devices > 1 or cfg.coordinator or cfg.num_processes > 0 \
            or cfg.process_id >= 0:
        raise ValueError("more than one device or process (--num_devices > 1, "
                         "--coordinator, --num_processes, --process_id) is not ported "
                         "(ROADMAP Queue 1 item 6)")


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


def run(cfg: RunConfig) -> int:
    check_ported(cfg)
    device = resolve_device(cfg.platform)
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

            store = evstore.NormalizedStore(evstore.open_or_build_h5(path), offset, origin)
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
                  rv_pos=cfg.rv_pos, vopts=vopts, on_subinterval=on_sub)

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
    from .checkpoint import RunCheckpoint, config_fingerprint

    fopts = pipeline.FullSeqOptions(
        start_time=cfg.start_time_s, stop_time=cfg.stop_time_s,
        duration=cfg.duration, out_skip=cfg.out_skip,
        forward_looking=cfg.forward_looking)
    # The skip predicate rides into the scheduler, so a resumed chunk never
    # reaches process(): resume saves the voting, not only the writes.
    ckpt = RunCheckpoint(os.path.join(cfg.out_path, "checkpoint.json"),
                         fingerprint=config_fingerprint(flag_text), enabled=cfg.checkpoint)
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
