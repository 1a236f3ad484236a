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

On the card the step is a program per key, the counterpart of the JAX
jit: the body is cut at the collectives that run (`segment_plan`), each
compute segment is one CUDA graph, and each collective runs eagerly
between two replays (gloo, which ranks sharing a card use, cannot be
captured).  A collective over a group of one rank is left out, as XLA's
over an axis of size 1 is the identity.  `graphs.eager()` (also
`mapper.eager()`) runs the body eagerly; the CPU always does.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import graphs
from ..kernels import binning
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


def device_step_tables(
    mappers: Sequence[Mapper],
    trajs: Sequence[trajmod.Trajectory],
    device,
) -> Tuple[torch.Tensor, ...]:
    """The event-independent arguments of a step less the RV placement, as
    float32 tensors on `device`: (traj_ts, traj_q, traj_t, lut, K_cam,
    Kv_inv, depths), the pose tables padded to the longest camera's by
    repeating the last row, on the trajectories' device (nothing read
    back).  A run builds them once; `with_placement` adds each chunk's
    T_rv_w."""
    n_pose = max(tr.n for tr in trajs)

    def pad_tail(a):
        if a.shape[0] == n_pose:
            return a
        return torch.cat([a, a[-1:].expand(n_pose - a.shape[0], *a.shape[1:])])

    poses = [torch.stack([pad_tail(getattr(tr, name) if name == "ts" else
                                   getattr(tr.poses, name)) for tr in trajs])
             for name in ("ts", "q", "t")]
    host = (np.stack([m.lut for m in mappers]),
            np.stack([np.asarray(m.cam.P, np.float32) for m in mappers]),
            np.asarray(np.linalg.inv(mappers[0].vcam.P), np.float32),
            np.asarray(mappers[0].depth_vec.depths(), np.float32))
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in (*poses, *host))


def with_placement(tables: Sequence[torch.Tensor], T_rv_w: SE3) -> tuple:
    """The 9 replicated arguments of a step: `device_step_tables`' with the
    RV placement between the poses and the LUTs."""
    return (*tables[:3], T_rv_w.q, T_rv_w.t, *tables[3:])


def replicated_step_tables(
    mappers: Sequence[Mapper],
    trajs: Sequence[trajmod.Trajectory],
    T_rv_w: SE3,
):
    """The 9 replicated arguments of a step as float32 host arrays:
    `device_step_tables` on the CPU with the placement."""
    return tuple(a.detach().cpu().numpy().astype(np.float32) for a in
                 with_placement(device_step_tables(mappers, trajs, "cpu"), T_rv_w))


def _replicated(mappers, trajs, T_rv_w, tables):
    """`tables` (`device_step_tables`, built once by the caller) with the
    placement, else `replicated_step_tables`."""
    if tables is None:
        return replicated_step_tables(mappers, trajs, T_rv_w)
    return with_placement(tables, T_rv_w)


def sharded_step_inputs(
    mappers: Sequence[Mapper],
    events: Sequence[Events],
    trajs: Sequence[trajmod.Trajectory],
    T_rv_w: SE3,
    n_event_shards: int,
    packet_size: int = voting.DEFAULT_PACKET_SIZE,
    capacity: int = None,
    tables: Sequence[torch.Tensor] = None,
):
    """The global arguments of a step: (x, y, t, w) of every camera's whole
    padded stream as host arrays, then the replicated tables (`tables` of
    `device_step_tables` with the placement where the caller built them,
    else `replicated_step_tables`)."""
    x, y, t, w = pad_events_for_sharding(events, n_event_shards, packet_size, capacity)
    return (x, y, t, w) + _replicated(mappers, trajs, T_rv_w, tables)


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
    tables: Sequence[torch.Tensor] = None,
):
    """This process's step arguments when each process holds only its slice
    of the chunk (`local_events`, e.g. the [p/P, (p+1)/P) fraction for
    process p of P): its padded event block and the replicated tables (as
    in `sharded_step_inputs`).  No process holds the global stream.

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
    return (x, y, t, w) + _replicated(mappers, trajs, T_rv_w, tables)


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


# The two steps, as the program keys name them.
FULL, VOTING = "full", "voting"
# Sharded step programs kept (all devices).  A program holds every camera of
# the rig, so a run needs one a bucket shape: process_1's chunk, process_2/5's
# sub-intervals and full_seq windows on both sides of a bucket edge (3-4, the
# count mapper.PROGRAM_CACHE_SIZE takes twice for its two cameras), on the
# full step (process_1) or the voting step (process_2/5).  Both kinds of a
# bucket set fit, so one process can hold the one kind against the other, as
# chip_smoke.py phase 10 does.  Each holds its camera DSIs, the fused DSI
# block and its inputs.
STEP_PROGRAM_CACHE_SIZE = 8


class _Op(NamedTuple):
    """One part of a step's body: `run(state)` computes on this rank's
    tensors, or, for a collective, `run(state, mesh)` joins the ranks."""

    name: str
    run: Callable
    collective: bool = False


def _ops(spec: ShardedRigSpec, cfg: ShardedStepConfig, kind: str,
         mesh_shape: Tuple[int, int], pi: int) -> List[_Op]:
    """The body of this rank's step of `kind` on a mesh of `mesh_shape`,
    plane coordinate `pi`, in order.  The state starts as {"args": the 13
    arguments on the device} and ends with "out".  A collective over a
    group of one rank is left out: XLA's `psum` and `all_gather` over an
    axis of size 1 are the identity."""
    n_event, n_plane = mesh_shape
    zblock = spec.dim_z // n_plane
    splat = voting.resolve_backend(cfg.backend)

    def prepare(s):
        depths = s["args"][12]
        kw = {}
        if cfg.backend.startswith("hist"):
            # The global correction midpoint: every plane block bins its
            # events with the same sweep correction, as the single-device
            # run does.
            u_full = 1.0 / depths
            kw["corr_u_mid"] = 0.5 * (torch.min(u_full) + torch.max(u_full))
            if kind == FULL:
                # w is the 0/1 padding mask of pad_events_for_sharding.
                kw["weights_binary"] = True
            if n_plane > 1:
                # A z-block keeps the whole sweep's segments (those outside
                # it empty), so each plane is merged and swept as on one
                # device; the JAX package re-segments each block.  A block
                # with fewer planes than segments is clamped, and
                # re-segmented, as there.
                kw["seg_bounds"] = _block_bounds(splat, spec.dim_z, pi * zblock,
                                                 (pi + 1) * zblock)
        s["splat_kw"], s["dsis"] = kw, []
        s["local_depths"] = depths[pi * zblock:(pi + 1) * zblock]

    def camera(c):
        def run(s):
            x, y, t, w, traj_ts, traj_q, traj_t, rv_q, rv_t, lut, K_cam, Kv_inv, _ = s["args"]
            traj = trajmod.Trajectory(traj_ts[c], SE3(traj_q[c], traj_t[c]))
            packets = voting.warp_events_to_z0(
                x[c], y[c], t[c], traj, SE3(rv_q, rv_t), lut[c], K_cam[c], Kv_inv,
                z0=spec.z0, width=spec.width, packet_size=cfg.packet_size,
                ev_weight=w[c], full=True)
            dsi = splat(packets, s["local_depths"], spec.z0, spec.vcam_params, spec.width,
                        spec.height, plane_block=cfg.plane_block, **s["splat_kw"])
            if kind == VOTING:
                # Each camera's block goes straight into the step's output,
                # so no part of the body runs after the last all-reduce.
                if c == 0:
                    s["out"] = dsi.new_empty((spec.n_cameras,) + tuple(dsi.shape))
                s["out"][c].copy_(dsi)
                dsi = s["out"][c]
            s["dsis"].append(dsi)
        return run

    def all_reduce(c):
        def run(s, mesh):
            dist.all_reduce(s["dsis"][c], group=mesh.get_group(EVENT_AXIS))
        return run

    ops = [_Op("prepare", prepare)]
    for c in range(spec.n_cameras):
        ops.append(_Op(f"camera{c}", camera(c)))
        if n_event > 1:
            ops.append(_Op(f"all_reduce camera{c}", all_reduce(c), True))
    if kind == VOTING:
        return ops

    def fuse_collapse(s):
        # Local collapse over the z-block, then the global decision from the
        # gathered (max, index) pairs; ties go to the lowest z, as a scan of
        # the whole axis does (argmax returns the first maximum).
        fused = gridops.fuse_many(s["dsis"], cfg.fusion_method)
        conf_l, idx_l = gridops.collapse(fused, cfg.extract_options.collapse_method)
        s["fused"] = fused
        s["conf"] = conf_l.contiguous()
        s["idx"] = (idx_l.to(torch.int32) + pi * zblock).contiguous()
        if n_plane == 1:
            s["confs"], s["idxs"] = [s["conf"]], [s["idx"]]
        else:
            s["confs"] = [torch.empty_like(s["conf"]) for _ in range(n_plane)]
            s["idxs"] = [torch.empty_like(s["idx"]) for _ in range(n_plane)]

    def all_gather(s, mesh):
        group = mesh.get_group(PLANE_AXIS)
        dist.all_gather(s["confs"], s["conf"], group=group)
        dist.all_gather(s["idxs"], s["idx"], group=group)

    def decide_extract(s):
        confs, idxs = torch.stack(s["confs"]), torch.stack(s["idxs"])
        best = torch.argmax(confs, dim=0)[None]
        conf = torch.take_along_dim(confs, best, dim=0)[0]
        idx = torch.take_along_dim(idxs, best, dim=0)[0]
        res = extract.extract_from_collapsed(conf, idx, spec.depth_vec, cfg.extract_options)
        s["out"] = {"dsi": s["fused"], "depth": res.depth, "confidence": res.confidence,
                    "mask": res.mask, "depth_indices": res.depth_indices}

    ops.append(_Op("fuse+collapse", fuse_collapse))
    if n_plane > 1:
        ops.append(_Op("all_gather", all_gather, True))
    ops.append(_Op("decide+extract", decide_extract))
    return ops


def _segments(ops: Sequence[_Op]) -> list:
    """The body as a program runs it: each run of compute ops one segment
    (a list of ops, one CUDA graph), each collective (an `_Op`) alone
    between them."""
    out: list = []
    for op in ops:
        if op.collective:
            out.append(op)
        elif out and isinstance(out[-1], list):
            out[-1].append(op)
        else:
            out.append([op])
    return out


def segment_plan(spec: ShardedRigSpec, cfg: ShardedStepConfig, kind: str,
                 mesh_shape: Tuple[int, int], pi: int = 0) -> list:
    """The names of `_segments`: a list of the ops' names for each segment,
    the collective's name between them."""
    return [[op.name for op in seg] if isinstance(seg, list) else seg.name
            for seg in _segments(_ops(spec, cfg, kind, mesh_shape, pi))]


def _run_ops(ops: Sequence[_Op], state: dict) -> None:
    for op in ops:
        op.run(state)


def _run_eager(segments: list, args: List[torch.Tensor], mesh: DeviceMesh,
               flag: torch.Tensor):
    """The body run eagerly on the device tensors `args`; its compute under
    deferred weight checks into `flag`."""
    state = {"args": args}
    for seg in segments:
        if isinstance(seg, list):
            with binning.deferred_weight_checks(flag):
                _run_ops(seg, state)
        else:
            seg.run(state, mesh)
    return state["out"]


def _signature(args) -> tuple:
    """The shapes and dtypes of a step's arguments (host arrays or tensors)."""
    return tuple((tuple(t.shape), t.dtype) for t in map(torch.as_tensor, args))


def step_key(device, mesh_shape, coordinate, backend: str, spec: ShardedRigSpec,
             cfg: ShardedStepConfig, kind: str, args) -> tuple:
    """The key of a sharded step's program: the device; the mesh shape,
    this rank's coordinate and the process group's backend; the rig spec
    and config (the JAX jit's static arguments); the step's kind; the
    shapes of its 13 arguments (`mapper.bucket_capacity` keeps few)."""
    return (torch.device(device), tuple(mesh_shape), tuple(int(i) for i in coordinate),
            backend, spec, cfg, kind, _signature(args))


_PROGRAMS = graphs.ProgramCache(STEP_PROGRAM_CACHE_SIZE)


def programs() -> list:
    """The sharded step programs held, least recently used first."""
    return _PROGRAMS.values()


def clear_programs() -> None:
    """Close every sharded step program held (their graphs and buffers)."""
    _PROGRAMS.clear()


class StepProgram:
    """This rank's body of a sharded step for one key, on its card: each
    compute segment captured in a CUDA graph (`graphs.Graph`), replayed in
    order with the collectives run eagerly between them on the same stream.

    It owns the 13 arguments' static buffers (the event arrays staged
    through pinned buffers, `graphs.Staging`; the tables copied) and the
    graphs, whose outputs the collectives read and write in place.  A call
    returns fresh copies of the step's outputs."""

    def __init__(self, key: tuple, segments: list, args, device: torch.device):
        self.key, self.segments, self.device = key, segments, device
        self.inputs = [torch.empty(t.shape, dtype=t.dtype, device=device)
                       for t in map(torch.as_tensor, args)]
        self.staging = graphs.Staging(self.inputs[:4])
        self.graphs: List[graphs.Graph] = []
        self.state: dict = {}
        self.capture_s = 0.0

    def _load(self, args) -> None:
        """The call's arguments into the static buffers, on the current
        stream: the event arrays (host arrays) through the pinned buffers
        not in flight, the tables by a copy each."""
        def fill(host):
            for h, a in zip(host, args[:4]):
                np.copyto(h, np.asarray(a))

        self.staging.load(fill)
        for dst, a in zip(self.inputs[4:], args[4:]):
            dst.copy_(torch.as_tensor(a), non_blocking=True)

    def capture(self, mesh: DeviceMesh, args, flag: torch.Tensor):
        """First use: stage the arguments, run the body eagerly, collectives
        included (`graphs.warm_up`), then capture each compute segment.
        Returns the eager run's outputs; the counts of its launches stand."""
        t0 = time.perf_counter()
        self._load(args)
        out = graphs.warm_up(self.device,
                             lambda: _run_eager(self.segments, self.inputs, mesh, flag), flag)
        self.state = {"args": self.inputs}
        for seg in self.segments:
            if isinstance(seg, list):
                self.graphs.append(graphs.Graph(
                    self.device, functools.partial(_run_ops, seg, self.state), flag))
        self.capture_s = time.perf_counter() - t0
        return out

    def __call__(self, mesh: DeviceMesh, args):
        """Stage, replay the segments with the collectives between them, and
        copy the outputs into fresh tensors."""
        self._load(args)
        replays = iter(self.graphs)
        for seg in self.segments:
            if isinstance(seg, list):
                next(replays).replay()
            else:
                seg.run(self.state, mesh)
        out = self.state["out"]
        if isinstance(out, dict):
            return {k: v.clone() for k, v in out.items()}
        return out.clone()

    def close(self) -> None:
        """Drop the graphs and their buffers once the card is done with them."""
        if self.graphs:
            torch.cuda.synchronize(self.device)
        self.graphs, self.state = [], {}


def _check_mesh(mesh: DeviceMesh, spec: ShardedRigSpec) -> None:
    if mesh.mesh_dim_names != (EVENT_AXIS, PLANE_AXIS):
        raise ValueError(f"mesh axes must be {(EVENT_AXIS, PLANE_AXIS)}, got "
                         f"{mesh.mesh_dim_names}")
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the mesh")
    if spec.dim_z % mesh.size(1) != 0:
        raise ValueError(f"dim_z {spec.dim_z} not divisible by plane shards {mesh.size(1)}")


def _make_step(mesh: DeviceMesh, spec: ShardedRigSpec, cfg: ShardedStepConfig, kind: str):
    """This rank's step of `kind`: on the card outside `graphs.eager()` the
    program of `step_key` (captured on first use; a failed capture or
    replay raises), else the body run eagerly.  The full step reads the
    fault flags once its extraction is queued (`graphs.check_faults`); the
    voting step leaves them to its caller."""
    _check_mesh(mesh, spec)
    shape = (mesh.size(0), mesh.size(1))
    segments = _segments(_ops(spec, cfg, kind, shape, mesh.get_local_rank(PLANE_AXIS)))
    dev = mesh_device(mesh)

    def step(*args):
        flag = graphs.fault_flag(dev)
        if graphs.use_programs(dev):
            key = step_key(dev, shape, mesh.get_coordinate(), dist.get_backend(), spec, cfg,
                           kind, args)
            prog = _PROGRAMS.get(key)
            if prog is None:
                prog = StepProgram(key, segments, args, dev)
                out = prog.capture(mesh, args, flag)
                _PROGRAMS.put(key, prog)
            else:
                out = prog(mesh, args)
        else:
            out = _run_eager(segments, [torch.as_tensor(a, device=dev) for a in args], mesh,
                             flag)
        graphs.mark_pending(dev)
        if kind == FULL:
            graphs.check_faults()
        return out

    return step


def make_sharded_step(
    mesh: DeviceMesh,
    spec: ShardedRigSpec,
    cfg: ShardedStepConfig = ShardedStepConfig(),
) -> Callable[..., Dict[str, torch.Tensor]]:
    """The full chunk step of this rank of `mesh`, on the mesh's device.

    step(x, y, t, w, traj_ts, traj_q, traj_t, rv_q, rv_t, lut, K_cam, Kv_inv,
    depths), with the rank's event block (`local_inputs`; the event arrays
    on the host, the rest host arrays or tensors), returns fresh tensors:
      "dsi": this rank's (Z / n_plane, H, W) block of the fused DSI;
      "depth", "confidence", "mask", "depth_indices": the 2D maps, equal on
      every rank.
    Every rank of the mesh calls it in step, since it runs collectives.  On
    the card it replays a program (`StepProgram`), the counterpart of the
    JAX package's jit; refused binning weights raise before it returns.
    """
    return _make_step(mesh, spec, cfg, FULL)


def make_sharded_voting_step(
    mesh: DeviceMesh,
    spec: ShardedRigSpec,
    cfg: ShardedStepConfig = ShardedStepConfig(),
) -> Callable[..., torch.Tensor]:
    """The voting of `make_sharded_step` alone: step(*args) returns this
    rank's (ncam, Z / n_plane, H, W) block of the per-camera DSIs, summed
    over the event group, with no fusion or collapse.  The temporal
    pipelines (process_2/5) vote each sub-interval with it; their HM/AM
    accumulators are elementwise, so they can stay plane-split.  Refused
    binning weights raise at the caller's next `mapper.check_faults`."""
    return _make_step(mesh, spec, cfg, VOTING)


def gather_planes(mesh: DeviceMesh, block: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The whole DSI from every rank's z-block `block` (planes on `dim`),
    gathered over the plane group; `block` itself without plane shards."""
    n_plane = mesh.size(1)
    if n_plane == 1:
        return block
    parts = [torch.empty_like(block) for _ in range(n_plane)]
    dist.all_gather(parts, block.contiguous(), group=mesh.get_group(PLANE_AXIS))
    return torch.cat(parts, dim=dim)
