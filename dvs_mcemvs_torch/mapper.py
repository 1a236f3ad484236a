"""Per-camera EMVS mapper: DSI setup, event back-projection, extraction.

Port of dvs_mcemvs_tpu/mapper.py: an immutable per-camera setup (virtual
camera, rectification LUT, depth planes) whose `evaluate_dsi` turns a chunk
of events into a fresh (Z, H, W) DSI on the device of the trajectory, and
`get_pointcloud`, which turns a depth map into a filtered point cloud.

On a CUDA device `evaluate_dsi` runs a *program* (`graphs.Captured`), the
counterpart of the JAX package's `_evaluate_dsi_jit`: the chunk's body
(warp and vote) captured once in a CUDA graph per `program_key` (the jit's
static arguments and the input shapes, which `bucket_capacity` keeps few)
and replayed for every later chunk of that key, one launch from the host.
Every path stages a chunk by `_stage`: tensors on the card device to
device; host arrays sliced from a stream that the run page-locked in place
(`page_lock`) by DMA, the float32 time cast on the card; other host arrays
cast on the host, through a program's pinned buffers or plainly; then the
bucket pad, always on the buffers' device.
`get_depth_map` replays an extraction program per `extraction_key` the
same way, the counterpart of the jitted extraction of
`__graft_entry__.entry` and `bench.py`'s `full_chunk`.
Inside `eager()` (the counterpart of `jax.disable_jit()`), and on the CPU,
the same bodies run eagerly.  The bodies read nothing back from the device:
the binning's weight checks set a per-device fault flag, which
`check_faults` reads once a chunk (`get_depth_map`,
`pipeline._synchronize`).  The capture, the staging, the program cache,
`eager()` and the fault flags are `graphs`', shared with the pipelines'
fusion and temporal programs and the sharded step's (`parallel.sharded`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import graphs, tracing
from .graphs import ProgramCache, check_faults, eager  # noqa: F401  (the mapper's API)
from .kernels import binning
from .ops import camera as camops, extract, pointcloud as pcops, trajectory as trajmod, voting
from .ops.camera import PinholeCamera, rectify_lut, virtual_camera
from .ops.depth_vector import DepthVector, LINEAR
from .ops.se3 import SE3

# Programs kept (all devices): two cameras times the bucket shapes of a run
# (process_1's chunk, process_2/5's sub-intervals, full_seq windows on both
# sides of a bucket edge: 3-4), with room for a second trajectory set, as
# the golden gates' runs beside the headline chunk.  Each holds its DSI (123
# MB at 640x480x100) and its input buffers; the least recently used program
# beyond this is dropped with its graph.
PROGRAM_CACHE_SIZE = 16


@dataclasses.dataclass(frozen=True)
class DsiShape:
    """Mirrors EMVS::ShapeDSI."""

    dim_x: int = 0  # 0 = use camera resolution
    dim_y: int = 0
    dim_z: int = 100
    fov_deg: float = 0.0  # < 10 = use camera focal length
    min_depth: float = 0.3
    max_depth: float = 10.0


class Events(NamedTuple):
    """A chunk of events from one camera, sorted by time: host arrays, or
    tensors (on the CPU, or already on the card that votes them)."""

    x: np.ndarray  # (E,) int
    y: np.ndarray  # (E,) int
    t: np.ndarray  # (E,) float seconds
    p: Optional[np.ndarray] = None  # (E,) polarity, optional

    @property
    def num(self) -> int:
        return int(self.x.shape[0])

    def slice(self, lo: int, hi: int) -> "Events":
        p = None if self.p is None else self.p[lo:hi]
        return Events(self.x[lo:hi], self.y[lo:hi], self.t[lo:hi], p)

    def time_window(self, t0: float, t1: float) -> "Events":
        """Events with t in [t0, t1], by binary search on the times: on the
        host for arrays, on the tensors' device for tensors (the two bounds
        read back once)."""
        if isinstance(self.t, torch.Tensor):
            # The bounds in the times' dtype, as numpy compares a float32
            # array with a Python float.
            bounds = torch.tensor([t0, t1], dtype=self.t.dtype, device=self.t.device)
            lo = torch.searchsorted(self.t, bounds[:1], side="left")
            hi = torch.searchsorted(self.t, bounds[1:], side="right")
            lo, hi = torch.cat([lo, hi]).tolist()
        else:
            lo = int(np.searchsorted(self.t, t0, side="left"))
            hi = int(np.searchsorted(self.t, t1, side="right"))
        return self.slice(lo, hi)


@dataclasses.dataclass(frozen=True)
class Mapper:
    """Immutable per-camera mapping setup."""

    cam: PinholeCamera
    vcam: PinholeCamera
    depth_vec: DepthVector
    lut: np.ndarray  # (H*W, 2) float32 rectified pixel coordinates

    @property
    def width(self) -> int:
        return self.vcam.width

    @property
    def height(self) -> int:
        return self.vcam.height

    @property
    def dsi_shape(self) -> Tuple[int, int, int]:
        return (self.depth_vec.n, self.vcam.height, self.vcam.width)


def make_mapper(cam: PinholeCamera, shape: DsiShape,
                depth_sampling: str = LINEAR) -> Mapper:
    """Build the per-camera setup."""
    dim_x = shape.dim_x or cam.width
    dim_y = shape.dim_y or cam.height
    vcam = virtual_camera(dim_x, dim_y, shape.fov_deg, cam)
    dv = DepthVector(depth_sampling, shape.min_depth, shape.max_depth, shape.dim_z)
    return Mapper(cam=cam, vcam=vcam, depth_vec=dv, lut=rectify_lut(cam))


def bucket_capacity(n: int, packet_size: int) -> int:
    """Smallest power-of-two packet count covering n events, in events: the
    programs' event shapes under pad="bucket" (O(log E) programs a run)."""
    k = -(-n // packet_size)
    return packet_size * (1 << max(k - 1, 0).bit_length())


def _n_static(n: int, packet_size: int, pad: str) -> int:
    """Events the body takes: the bucket capacity, or the chunk's own count."""
    if pad == "bucket":
        return bucket_capacity(n, packet_size)
    if pad != "none":
        raise ValueError(f"pad must be 'none' or 'bucket', got {pad!r}")
    return n


def _on_device(events: Events, device: torch.device) -> bool:
    """Whether the chunk's x, y, t are tensors on `device` (staged there,
    device to device); False for host arrays and CPU tensors (staged through
    the host).  Tensors on any other device raise."""
    fields = (events.x, events.y, events.t)
    devices = {f.device for f in fields if isinstance(f, torch.Tensor)}
    tensors = all(isinstance(f, torch.Tensor) for f in fields)
    if devices <= {torch.device("cpu")} and not (tensors and device.type == "cpu"):
        return False
    if devices != {device} or not tensors:
        raise ValueError(f"events on {sorted(map(str, devices))}: they must be host arrays, "
                         f"CPU tensors or tensors on the trajectory's device {device}")
    return True


def _pad_device(x: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
                w: Optional[torch.Tensor], n: int) -> None:
    """The bucket pad past the chunk's n events, on the buffers' device and
    the current stream: zero-weight events (w: 1 up to n) at pixel (0, 0)
    and the last event's time."""
    x[n:].zero_()
    y[n:].zero_()
    t[n:].copy_(t[n - 1:n].expand(t.shape[0] - n))
    if w is not None:
        w[:n].fill_(1.0)
        w[n:].zero_()


def _dma_types(events: Events) -> bool:
    """Whether the chunk's x, y and t are host arrays of the dtypes that
    `_stage` copies by DMA as they are (int32, int32, float64)."""
    fields = (events.x, events.y, events.t)
    return (all(isinstance(f, np.ndarray) for f in fields)
            and (events.x.dtype, events.y.dtype, events.t.dtype)
            == (np.int32, np.int32, np.float64))


def page_lock(streams: Sequence[Events], device: torch.device) -> None:
    """Page-lock in place (`graphs.PAGE_LOCKS`, once a process) the host
    arrays of a run's event streams that `_stage` can copy by DMA, where
    their chunks are voted by programs on `device`."""
    if graphs.use_programs(device):
        for ev in streams:
            if _dma_types(ev):
                graphs.PAGE_LOCKS.lock(ev.x, ev.y, ev.t)


def _stage(events: Events, bufs: Sequence[Optional[torch.Tensor]],
           staging: Optional[graphs.Staging] = None) -> None:
    """Write the chunk into `bufs` (x, y int32, t float32 and, under
    pad="bucket", w float32, else None) on their device and the current
    stream, by its source: tensors on that device, device to device; int32,
    int32, float64 host arrays in page-locked memory (`page_lock`), by DMA,
    t into a float64 scratch cast on the device (to nearest, as numpy's);
    other host arrays, cast by numpy on the host, through `staging`'s
    pinned set not in flight where a program has one, else plainly.  Then
    the bucket pad (`_pad_device`).  The tracer counts the camera-chunk
    under "dma" or "fill" (`tracing.staged`)."""
    x, y, t, w = bufs
    n, dev = events.num, x.device
    srcs = (events.x, events.y, events.t)
    path = "fill"
    if _on_device(events, dev):
        path = None
        tracing.mark()
        for buf, src in zip((x, y, t), srcs):
            buf[:n].copy_(src, non_blocking=True)
    elif _dma_types(events) and graphs.PAGE_LOCKS.locked(*srcs):
        path = "dma"
        t64 = torch.empty(x.shape[0], dtype=torch.float64, device=dev)
        tracing.mark()
        for buf, src in zip((x, y, t64), srcs):
            buf[:n].copy_(torch.from_numpy(src), non_blocking=True)
        t[:n].copy_(t64[:n])
    elif staging is not None:
        staging.load(srcs)
    else:
        for buf, src, dtype in zip((x, y, t), srcs, (np.int32, np.int32, np.float32)):
            buf[:n].copy_(torch.from_numpy(np.asarray(src, dtype)))
    tracing.staged(n, x.shape[0] - n, path)
    _pad_device(x, y, t, w, n)
    if path == "dma":
        # The run's arrays are released only after the copies from them.
        graphs.PAGE_LOCKS.copied(dev, *srcs)


class _Body(NamedTuple):
    """The body's static arguments (the JAX jit's static_argnames)."""

    z0: float
    width: int
    height: int
    vcam_params: Tuple[float, float, float, float]
    packet_size: int
    backend: str
    plane_block: int
    rect_params: Optional[tuple]


class _Constants(NamedTuple):
    """The mapper's constants on a device: plane depths, the camera's and the
    virtual camera's intrinsics, and the LUT under rectify="lut"."""

    depths: torch.Tensor
    K_cam: torch.Tensor
    Kv_inv: torch.Tensor
    lut: Optional[torch.Tensor]


def _setup(mapper: Mapper, packet_size: int, backend: str, plane_block: int,
           rectify: str) -> _Body:
    if rectify not in ("device", "lut"):
        raise ValueError(f"rectify must be 'device' or 'lut', got {rectify!r}")
    vc = mapper.vcam
    return _Body(z0=float(mapper.depth_vec.depths()[0]), width=mapper.width,
                 height=mapper.height,
                 vcam_params=(float(vc.fx), float(vc.fy), float(vc.cx), float(vc.cy)),
                 packet_size=packet_size, backend=backend, plane_block=plane_block,
                 rect_params=camops.rect_static(mapper.cam) if rectify == "device" else None)


def _constants(mapper: Mapper, body: _Body, device) -> _Constants:
    return _Constants(
        depths=torch.as_tensor(mapper.depth_vec.depths(), device=device),
        K_cam=torch.as_tensor(mapper.cam.P.astype(np.float32), device=device),
        Kv_inv=torch.as_tensor(np.linalg.inv(mapper.vcam.P).astype(np.float32),
                               device=device),
        lut=None if body.rect_params is not None else torch.as_tensor(mapper.lut,
                                                                      device=device))


def _warp(body: _Body, c: _Constants, x, y, t, w, traj: trajmod.Trajectory,
          T_rv_w: SE3) -> voting.WarpedPackets:
    return voting.warp_events_to_z0(
        x, y, t, traj, T_rv_w, c.lut, c.K_cam, c.Kv_inv, z0=body.z0, width=body.width,
        packet_size=body.packet_size, rect_params=body.rect_params, ev_weight=w,
        full=w is not None)


def _vote(body: _Body, c: _Constants, x, y, t, w, traj: trajmod.Trajectory,
          T_rv_w: SE3) -> torch.Tensor:
    """The chunk's body: device tensors in, a (Z, H, W) DSI out; it touches
    no host array and reads nothing from the device."""
    packets = _warp(body, c, x, y, t, w, traj, T_rv_w)
    fn = voting.resolve_backend(body.backend)
    return fn(packets, c.depths, body.z0, body.vcam_params, body.width, body.height,
              plane_block=body.plane_block)


def _event_buffers(n: int, weighted: bool, device) -> list:
    """Buffers that `_stage` writes a chunk of n events into: x, y
    (int32), t (float32) and w (float32) where `weighted`, else None."""
    i32, f32 = dict(dtype=torch.int32, device=device), dict(dtype=torch.float32, device=device)
    return [torch.empty(n, **i32), torch.empty(n, **i32), torch.empty(n, **f32),
            torch.empty(n, **f32) if weighted else None]


def _device_events(events: Events, packet_size: int, pad: str, device) -> list:
    """The chunk staged into fresh buffers on `device` (x, y, t, w or
    None): the eager path's inputs."""
    bufs = _event_buffers(_n_static(events.num, packet_size, pad), pad == "bucket", device)
    _stage(events, bufs)
    return bufs


def warp_chunk(
    mapper: Mapper,
    events: Events,
    traj: trajmod.Trajectory,
    T_rv_w: SE3,
    packet_size: int = voting.DEFAULT_PACKET_SIZE,
    rectify: str = "device",
    pad: str = "none",
) -> Tuple[voting.WarpedPackets, torch.Tensor, float]:
    """The chunk's events as packets on the z0 plane of the reference view,
    on the trajectory's device, eagerly: (packets, plane depths, z0).
    `rectify` and `pad` as in `evaluate_dsi`."""
    body = _setup(mapper, packet_size, "", 0, rectify)
    c = _constants(mapper, body, traj.device)
    x, y, t, w = _device_events(events, packet_size, pad, traj.device)
    return _warp(body, c, x, y, t, w, traj, T_rv_w), c.depths, body.z0


# ---------------------------------------------------------------------------
# Programs: the body captured in a CUDA graph per key
# ---------------------------------------------------------------------------


def program_key(mapper: Mapper, n_events: int, traj: trajmod.Trajectory,
                packet_size: int = voting.DEFAULT_PACKET_SIZE, backend: str = "scatter",
                plane_block: int = 8, rectify: str = "device", pad: str = "none") -> tuple:
    """The key of the program that votes a chunk of `n_events`: the JAX
    jit's static arguments (the body's `_Body`: z0, size, vcam and rect
    params, packet size, backend, plane block) and what fixes the
    constants (the camera's intrinsics and distortion, the virtual camera,
    the depth planes, the LUT under rectify="lut"), the input shapes (events
    under `pad`, poses), the device, and the camera: the trajectory's pose
    buffer, so each camera of a rig has programs of its own."""
    body = _setup(mapper, packet_size, backend, plane_block, rectify)
    lut = id(mapper.lut) if rectify == "lut" else None
    return (traj.device, body, camops.rect_static(mapper.cam), mapper.vcam.P.tobytes(),
            mapper.depth_vec, lut, pad, _n_static(n_events, packet_size, pad), traj.n,
            id(traj.poses.t))


_PROGRAMS = ProgramCache(PROGRAM_CACHE_SIZE)


def programs() -> list:
    """The programs held, least recently used first."""
    return _PROGRAMS.values()


def _program(mapper: Mapper, body: _Body, n_static: int, weighted: bool,
             traj: trajmod.Trajectory) -> graphs.Captured:
    """The vote program of one key (kind "vote"): static event buffers (x,
    y, t and, where `weighted`, w: first), poses and T_rv_w; its load
    stages a call's chunk (`_stage`, through a `graphs.Staging`) and copies
    the poses inside the tracer's `vote.stage`; its body is `_vote`."""
    dev = traj.device
    c = _constants(mapper, body, dev)
    events = _event_buffers(n_static, weighted, dev)
    staging = graphs.Staging(events[:3])
    poses = [torch.zeros_like(traj.ts), torch.zeros_like(traj.poses.q),
             torch.zeros_like(traj.poses.t)]
    T_rv_w = [torch.zeros(4, dtype=torch.float32, device=dev),
              torch.zeros(3, dtype=torch.float32, device=dev)]

    # The key holds the ids of the pose buffer (and the LUT): the load keeps
    # them alive (`_held`), so that no other object takes those ids while
    # the program lives.
    def load(ev: Events, trj: trajmod.Trajectory, T: SE3,
             _held=(traj.poses.t, mapper.lut)) -> None:
        with tracing.span("vote.stage", dev):
            _stage(ev, events, staging)
            for dst, src in zip(poses, (trj.ts, trj.poses.q, trj.poses.t)):
                dst.copy_(src)
            T_rv_w[0].copy_(T.q.reshape(4))
            T_rv_w[1].copy_(T.t.reshape(3))

    run = functools.partial(_vote, body, c, *events,
                            trajmod.Trajectory(poses[0], SE3(poses[1], poses[2])), SE3(*T_rv_w))
    static = [b for b in events if b is not None] + poses + T_rv_w
    return graphs.Captured(dev, static, run, kind="vote", load=load)


def evaluate_dsi(
    mapper: Mapper,
    events: Events,
    traj: trajmod.Trajectory,
    T_rv_w: SE3,
    packet_size: int = voting.DEFAULT_PACKET_SIZE,
    backend: str = "scatter",
    plane_block: int = 8,
    rectify: str = "device",
    pad: str = "none",
) -> Optional[torch.Tensor]:
    """Back-project a chunk of events into a fresh (Z, H, W) float32 DSI on
    the trajectory's device; None when the chunk is at most one packet.
    The events may be host arrays, CPU tensors or tensors on the
    trajectory's device (staged there with no host round trip); tensors on
    another device raise.  Host arrays may be read by the card after the
    call returns (by DMA, `_stage`): they must not change until the
    device's work queued so far is done.

    `rectify` = "device" recomputes rectification per event; "lut" gathers
    the host LUT.  `pad` = "bucket" pads the events with zero-weight events
    to a power-of-two packet capacity, so the trailing partial packet votes;
    "none" drops the events past the last full packet, as the reference.

    On a CUDA device outside `eager()` this replays the program of
    `program_key`, capturing it on first use; a failed capture or replay
    raises.  Refused binning weights raise at the next `check_faults`.
    """
    if events.num <= packet_size:
        return None
    body = _setup(mapper, packet_size, backend, plane_block, rectify)
    dev = traj.device
    if graphs.use_programs(dev):
        key = program_key(mapper, events.num, traj, packet_size, backend, plane_block,
                          rectify, pad)
        n_static = _n_static(events.num, packet_size, pad)
        dsi = _PROGRAMS.call(key, lambda: _program(mapper, body, n_static, pad == "bucket",
                                                   traj), events, traj, T_rv_w)
    else:
        x, y, t, w = _device_events(events, packet_size, pad, dev)
        with binning.deferred_weight_checks(graphs.fault_flag(dev)):
            dsi = _vote(body, _constants(mapper, body, dev), x, y, t, w, traj, T_rv_w)
    graphs.mark_pending(dev)
    return dsi


# ---------------------------------------------------------------------------
# Extraction programs: get_depth_map's body captured per key
# ---------------------------------------------------------------------------

# Extraction programs kept (all devices): a run's DSI shape under its
# options, and the focus collapses, the 300-plane chunk and the smaller
# rigs that one process (chip_smoke.py) extracts beside it.  Each holds a
# static DSI (123 MB at 640x480x100) and its maps.
EXTRACTION_CACHE_SIZE = 8

_EXTRACTIONS = ProgramCache(EXTRACTION_CACHE_SIZE)


def extraction_key(dsi: torch.Tensor, depth_vec: DepthVector,
                   options: extract.DepthMapOptions) -> tuple:
    """The key of the program that extracts a depth map from `dsi`: its
    device, shape and dtype, the options and the depth planes (the static
    arguments of the JAX package's jitted extraction)."""
    return (dsi.device, tuple(dsi.shape), dsi.dtype, options, depth_vec)


def extraction_programs() -> list:
    """The extraction programs held, least recently used first."""
    return _EXTRACTIONS.values()


def clear_programs() -> None:
    """Close every chunk and extraction program held (their graphs and
    buffers)."""
    _PROGRAMS.clear()
    _EXTRACTIONS.clear()


def get_depth_map(mapper: Mapper, dsi: torch.Tensor,
                  options: extract.DepthMapOptions) -> extract.DepthMapResult:
    """getDepthMapFromDSI on this mapper's depth planes
    (`extract.extraction_body`).  On a CUDA device outside `eager()` it
    replays the program of `extraction_key` (captured on first use; the DSI
    is copied into its static input, the maps come back fresh); elsewhere
    the body runs eagerly.  Raises, once the extraction is queued, if a
    chunk voted since the last check had refused weights (`check_faults`)."""
    if graphs.use_programs(dsi.device):
        def make():
            static = torch.empty_like(dsi)
            return graphs.Captured(dsi.device, [static], functools.partial(
                extract.extraction_body, static, mapper.depth_vec, options), kind="extract")

        maps = _EXTRACTIONS.call(extraction_key(dsi, mapper.depth_vec, options), make, dsi)
        res = extract.DepthMapResult(depth_dense=None, **maps)
    else:
        res = extract.get_depth_map_from_dsi(dsi, mapper.depth_vec, options)
    check_faults()
    return res


@dataclasses.dataclass(frozen=True)
class PointCloudOptions:
    """Mirrors EMVS::OptionsPointCloud."""

    radius_search: float = 0.05
    min_num_neighbors: int = 3


def get_pointcloud(mapper: Mapper, depth, mask, options: PointCloudOptions,
                   backend: str = "kdtree") -> pcops.PointCloud:
    """getPointcloud: unproject the masked pixels of a depth map (tensors
    or host arrays) and drop radius outliers."""
    pc = pcops.depth_map_to_pointcloud(depth, mask, mapper.vcam)
    return pcops.radius_outlier_removal(
        pc, options.radius_search, options.min_num_neighbors, backend=backend)
