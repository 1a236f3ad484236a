"""The sharded multi-camera chunk step over the ("event", "plane") mesh.

Port of dvs_mcemvs_tpu/parallel/sharded.py.  The JAX package compiles the
step once under `shard_map`; here every rank runs the body on its own
tensors and the collectives of torch.distributed stand in for XLA's:

  - events are split along "event": each rank votes a partial DSI for its
    slice of the stream and an `all_reduce` over the event group rebuilds
    the grid (voting is a sum over events, so the result is the
    single-device grid up to float reassociation);
  - depth planes are split along "plane": each rank votes its z-block
    without communication, and only the collapsed 2D (confidence, index)
    maps are `all_gather`ed for the global depth decision;
  - the extraction after the collapse runs on every rank (it is 2D).

A step takes the rank's own block of the event arrays: `local_inputs` cuts
it from the global arrays of `sharded_step_inputs`, and
`sharded_step_inputs_multihost` builds it from the events a process holds.
Buffers are padded to shard and packet multiples with zero-weight events.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..mapper import Events, Mapper
from ..ops import extract, grid as gridops, trajectory as trajmod, voting
from ..ops.depth_vector import DepthVector
from ..ops.se3 import SE3
from .mesh import EVENT_AXIS, PLANE_AXIS, mesh_device


@dataclasses.dataclass(frozen=True)
class ShardedRigSpec:
    """Static description of the rig and DSI geometry."""

    n_cameras: int
    width: int
    height: int
    dim_z: int
    z0: float
    vcam_params: Tuple[float, float, float, float]  # fx, fy, cx, cy of the RV camera
    depth_vec: DepthVector


@dataclasses.dataclass(frozen=True)
class ShardedStepConfig:
    """Algorithm knobs of the fused step."""

    fusion_method: int = gridops.FUSE_HM
    packet_size: int = voting.DEFAULT_PACKET_SIZE
    backend: str = "scatter"
    plane_block: int = 8
    extract_options: extract.DepthMapOptions = extract.DepthMapOptions()


def rig_spec_from_mappers(mappers: Sequence[Mapper]) -> ShardedRigSpec:
    m0 = mappers[0]
    return ShardedRigSpec(
        n_cameras=len(mappers), width=m0.width, height=m0.height, dim_z=m0.depth_vec.n,
        z0=float(m0.depth_vec.depths()[0]),
        vcam_params=(float(m0.vcam.fx), float(m0.vcam.fy),
                     float(m0.vcam.cx), float(m0.vcam.cy)),
        depth_vec=m0.depth_vec)


def pad_events_for_sharding(
    events: Sequence[Events],
    n_event_shards: int,
    packet_size: int = voting.DEFAULT_PACKET_SIZE,
    capacity: int = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-camera events stacked into (ncam, E_pad) x, y, t and vote weights
    w.  E_pad is a multiple of `n_event_shards * packet_size` covering the
    largest stream (or `capacity`, to keep shapes fixed across chunks).
    Padding events carry weight 0 and the camera's last timestamp, so they
    fill valid packets and vote nothing."""
    quantum = n_event_shards * packet_size
    max_e = max(ev.num for ev in events)
    if capacity is not None:
        if capacity < max_e:
            raise ValueError(f"capacity {capacity} < largest stream {max_e}")
        max_e = capacity
    # All-empty streams still pad to one quantum, so the shapes stay valid.
    e_pad = int(-(-max(max_e, 1) // quantum) * quantum)

    ncam = len(events)
    x = np.zeros((ncam, e_pad), np.int32)
    y = np.zeros((ncam, e_pad), np.int32)
    t = np.zeros((ncam, e_pad), np.float32)
    w = np.zeros((ncam, e_pad), np.float32)
    for c, ev in enumerate(events):
        n = ev.num
        x[c, :n] = ev.x
        y[c, :n] = ev.y
        t[c, :n] = ev.t
        w[c, :n] = 1.0
        t[c, n:] = ev.t[-1] if n else 0.0
    return x, y, t, w


def pad_events_local(
    events: Sequence[Events],
    local_quantum: int,
    local_capacity: int = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """`pad_events_for_sharding` of one process's slice of the stream, to a
    multiple of `local_quantum` (its event shards x the packet size)."""
    return pad_events_for_sharding(events, 1, local_quantum, local_capacity)


def replicated_step_tables(
    mappers: Sequence[Mapper],
    trajs: Sequence[trajmod.Trajectory],
    T_rv_w: SE3,
):
    """The event-independent arguments of a step, as host arrays: pose
    tables (padded to the longest camera's by repeating the last row),
    the RV placement, undistortion LUTs, calibration matrices, plane
    depths."""
    n_pose = max(int(tr.ts.shape[0]) for tr in trajs)

    def pad_tail(a, n):
        a = a.detach().cpu().numpy()
        if a.shape[0] == n:
            return a
        return np.concatenate([a, np.repeat(a[-1:], n - a.shape[0], axis=0)], axis=0)

    traj_ts = np.stack([pad_tail(tr.ts, n_pose) for tr in trajs])
    traj_q = np.stack([pad_tail(tr.poses.q, n_pose) for tr in trajs])
    traj_t = np.stack([pad_tail(tr.poses.t, n_pose) for tr in trajs])
    lut = np.stack([m.lut for m in mappers])
    K_cam = np.stack([np.asarray(m.cam.P, np.float32) for m in mappers])
    Kv_inv = np.asarray(np.linalg.inv(mappers[0].vcam.P), np.float32)
    depths = np.asarray(mappers[0].depth_vec.depths(), np.float32)
    return (traj_ts.astype(np.float32), traj_q.astype(np.float32),
            traj_t.astype(np.float32), T_rv_w.q.detach().cpu().numpy().astype(np.float32),
            T_rv_w.t.detach().cpu().numpy().astype(np.float32), lut, K_cam, Kv_inv, depths)


def sharded_step_inputs(
    mappers: Sequence[Mapper],
    events: Sequence[Events],
    trajs: Sequence[trajmod.Trajectory],
    T_rv_w: SE3,
    n_event_shards: int,
    packet_size: int = voting.DEFAULT_PACKET_SIZE,
    capacity: int = None,
):
    """The global host arrays of a step: (x, y, t, w) of every camera's
    whole padded stream, then `replicated_step_tables`."""
    x, y, t, w = pad_events_for_sharding(events, n_event_shards, packet_size, capacity)
    return (x, y, t, w) + replicated_step_tables(mappers, trajs, T_rv_w)


def local_inputs(mesh: DeviceMesh, args):
    """`args` of `sharded_step_inputs` with the event arrays cut to this
    rank's block of the "event" axis (contiguous, in mesh order)."""
    n_event = mesh.size(0)
    ei = mesh.get_local_rank(EVENT_AXIS)
    e_local = args[0].shape[1] // n_event
    cut = tuple(a[:, ei * e_local:(ei + 1) * e_local] for a in args[:4])
    return cut + tuple(args[4:])


def sharded_step_inputs_multihost(
    mesh: DeviceMesh,
    mappers: Sequence[Mapper],
    local_events: Sequence[Events],
    trajs: Sequence[trajmod.Trajectory],
    T_rv_w: SE3,
    packet_size: int = voting.DEFAULT_PACKET_SIZE,
    local_capacity: int = None,
):
    """This process's step arguments when each process holds only its slice
    of the chunk (`local_events`, e.g. the [p/P, (p+1)/P) fraction for
    process p of P): its padded event block and the replicated tables.  No
    process holds the global stream.

    With `local_capacity` None the processes agree on a common pad by one
    all-gather of their longest stream; pass a capacity to skip it.  The
    result equals a single-process run of the concatenated stream only when
    each slice is a whole number of local quanta: otherwise a slice's
    padding falls mid-stream and shifts boundary packets' mid-times."""
    nproc = dist.get_world_size()
    n_event = mesh.size(0)
    if n_event % nproc != 0:
        raise ValueError(f"event shards {n_event} not divisible by processes {nproc}")
    if mesh.size(1) != 1:
        raise ValueError("a multi-process mesh has one rank a process on the event axis")
    local_quantum = (n_event // nproc) * packet_size
    if local_capacity is None and nproc > 1:
        dev = mesh_device(mesh)
        mine = torch.tensor([max(ev.num for ev in local_events)], dtype=torch.int64,
                            device=dev)
        every = [torch.zeros_like(mine) for _ in range(nproc)]
        dist.all_gather(every, mine)
        local_capacity = int(torch.stack(every).max())
    x, y, t, w = pad_events_local(local_events, local_quantum, local_capacity)
    return (x, y, t, w) + replicated_step_tables(mappers, trajs, T_rv_w)


def _block_bounds(splat, dim_z: int, lo: int, hi: int):
    """The segment bounds of a hist backend's whole sweep over `dim_z`
    planes, cut to the z-block [lo, hi) and counted from `lo` (segments
    outside the block are empty there); None for a backend without
    segments.  The block then merges and sweeps as the one-device run does
    where its edges fall on the edges of the butterfly's ranges (the
    headline's 16 segments over 100 planes on 2 or 4 blocks); a segment or
    range cut by an edge takes its merge point from the block's part."""
    kw = getattr(splat, "keywords", {})
    segments = kw.get("segments", 1)
    if segments <= 1 or segments > dim_z:
        return None
    bounds = kw.get("seg_bounds") or [round(s * dim_z / segments)
                                      for s in range(segments + 1)]
    return tuple(min(max(b - lo, 0), hi - lo) for b in bounds)


def _vote_local(spec: ShardedRigSpec, cfg: ShardedStepConfig, mesh: DeviceMesh,
                args, weights_binary: bool) -> List[torch.Tensor]:
    """The per-rank voting: each camera's events warped and voted into this
    rank's z-block, then summed over the event group.  Returns the
    per-camera (Z / n_plane, H, W) blocks."""
    dev = mesh_device(mesh)
    (x, y, t, w, traj_ts, traj_q, traj_t, rv_q, rv_t, lut, K_cam, Kv_inv,
     depths) = (torch.as_tensor(a, device=dev) for a in args)
    n_plane = mesh.size(1)
    zblock = spec.dim_z // n_plane
    pi = mesh.get_local_rank(PLANE_AXIS)
    local_depths = depths[pi * zblock:(pi + 1) * zblock]

    splat = voting.resolve_backend(cfg.backend)
    splat_kw = {}
    if cfg.backend.startswith("hist"):
        # The global correction midpoint: every plane block bins its events
        # with the same sweep correction, as the single-device run does.
        u_full = 1.0 / depths
        splat_kw["corr_u_mid"] = 0.5 * (torch.min(u_full) + torch.max(u_full))
        if weights_binary:
            # w is the 0/1 padding mask of pad_events_for_sharding.
            splat_kw["weights_binary"] = True
        if n_plane > 1:
            # A z-block keeps the whole sweep's segments (those outside it
            # empty), so each plane is merged and swept as on one device;
            # the JAX package re-segments each block.  A block with fewer
            # planes than segments is clamped, and re-segmented, as there.
            splat_kw["seg_bounds"] = _block_bounds(splat, spec.dim_z, pi * zblock,
                                                   (pi + 1) * zblock)
    group = mesh.get_group(EVENT_AXIS)
    dsis = []
    for c in range(spec.n_cameras):
        traj = trajmod.Trajectory(traj_ts[c], SE3(traj_q[c], traj_t[c]))
        packets = voting.warp_events_to_z0(
            x[c], y[c], t[c], traj, SE3(rv_q, rv_t), lut[c], K_cam[c], Kv_inv,
            z0=spec.z0, width=spec.width, packet_size=cfg.packet_size,
            ev_weight=w[c], full=True)
        dsi_c = splat(packets, local_depths, spec.z0, spec.vcam_params, spec.width,
                      spec.height, plane_block=cfg.plane_block, **splat_kw)
        dist.all_reduce(dsi_c, group=group)
        dsis.append(dsi_c)
    return dsis


def _check_mesh(mesh: DeviceMesh, spec: ShardedRigSpec) -> None:
    if mesh.mesh_dim_names != (EVENT_AXIS, PLANE_AXIS):
        raise ValueError(f"mesh axes must be {(EVENT_AXIS, PLANE_AXIS)}, got "
                         f"{mesh.mesh_dim_names}")
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the mesh")
    if spec.dim_z % mesh.size(1) != 0:
        raise ValueError(f"dim_z {spec.dim_z} not divisible by plane shards {mesh.size(1)}")


def make_sharded_step(
    mesh: DeviceMesh,
    spec: ShardedRigSpec,
    cfg: ShardedStepConfig = ShardedStepConfig(),
) -> Callable[..., Dict[str, torch.Tensor]]:
    """The full chunk step of this rank of `mesh`, on the mesh's device.

    step(x, y, t, w, traj_ts, traj_q, traj_t, rv_q, rv_t, lut, K_cam, Kv_inv,
    depths), with the rank's event block (`local_inputs`), returns:
      "dsi": this rank's (Z / n_plane, H, W) block of the fused DSI;
      "depth", "confidence", "mask", "depth_indices": the 2D maps, equal on
      every rank.
    Every rank of the mesh calls it in step, since it runs collectives.
    """
    _check_mesh(mesh, spec)
    n_plane = mesh.size(1)
    zblock = spec.dim_z // n_plane
    pi = mesh.get_local_rank(PLANE_AXIS)
    plane_group = mesh.get_group(PLANE_AXIS)

    def step(*args) -> Dict[str, torch.Tensor]:
        dsis = _vote_local(spec, cfg, mesh, args, weights_binary=True)
        fused = gridops.fuse_many(dsis, cfg.fusion_method)
        # Local collapse over the z-block, then the global decision from the
        # gathered (max, index) pairs; ties go to the lowest z, as a scan of
        # the whole axis does (argmax returns the first maximum).
        conf_l, idx_l = gridops.collapse(fused, cfg.extract_options.collapse_method)
        idx_l = idx_l.to(torch.int32) + pi * zblock
        confs = [torch.empty_like(conf_l) for _ in range(n_plane)]
        idxs = [torch.empty_like(idx_l) for _ in range(n_plane)]
        dist.all_gather(confs, conf_l.contiguous(), group=plane_group)
        dist.all_gather(idxs, idx_l.contiguous(), group=plane_group)
        confs, idxs = torch.stack(confs), torch.stack(idxs)
        best = torch.argmax(confs, dim=0)[None]
        conf = torch.take_along_dim(confs, best, dim=0)[0]
        idx = torch.take_along_dim(idxs, best, dim=0)[0]
        res = extract.extract_from_collapsed(conf, idx, spec.depth_vec, cfg.extract_options)
        return {"dsi": fused, "depth": res.depth, "confidence": res.confidence,
                "mask": res.mask, "depth_indices": res.depth_indices}

    return step


def make_sharded_voting_step(
    mesh: DeviceMesh,
    spec: ShardedRigSpec,
    cfg: ShardedStepConfig = ShardedStepConfig(),
) -> Callable[..., torch.Tensor]:
    """The voting of `make_sharded_step` alone: step(*args) returns this
    rank's (ncam, Z / n_plane, H, W) block of the per-camera DSIs, summed
    over the event group, with no fusion or collapse.  The temporal
    pipelines (process_2/5) vote each sub-interval with it; their HM/AM
    accumulators are elementwise, so they can stay plane-split."""
    _check_mesh(mesh, spec)

    def step(*args) -> torch.Tensor:
        return torch.stack(_vote_local(spec, cfg, mesh, args, weights_binary=False))

    return step


def gather_planes(mesh: DeviceMesh, block: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The whole DSI from every rank's z-block `block` (planes on `dim`),
    gathered over the plane group; `block` itself without plane shards."""
    n_plane = mesh.size(1)
    if n_plane == 1:
        return block
    parts = [torch.empty_like(block) for _ in range(n_plane)]
    dist.all_gather(parts, block.contiguous(), group=mesh.get_group(PLANE_AXIS))
    return torch.cat(parts, dim=dim)
