"""Per-camera EMVS mapper: DSI setup, event back-projection, extraction.

Port of dvs_mcemvs_tpu/mapper.py: an immutable per-camera setup (virtual
camera, rectification LUT, depth planes) whose `evaluate_dsi` turns a chunk
of events into a fresh (Z, H, W) DSI on the device of the trajectory, and
`get_pointcloud`, which turns a depth map into a filtered point cloud.

On a CUDA device `evaluate_dsi` runs a *program*, the counterpart of the
JAX package's `_evaluate_dsi_jit`: the chunk's body (warp and vote) captured
once in a CUDA graph per `program_key` (the jit's static arguments and the
input shapes, which `bucket_capacity` keeps few) and replayed for every
later chunk of that key, one launch from the host.  Inside `eager()` (the
counterpart of `jax.disable_jit()`), and on the CPU, the same body runs
eagerly.  The body reads nothing back from the device: the binning's weight
checks set a per-device fault flag, which `check_faults` reads once a chunk
(`get_depth_map`, `pipeline._synchronize`).  The capture, the staging, the
program cache, `eager()` and the fault flags are `graphs`', shared with the
sharded step's programs (`parallel.sharded`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import graphs
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
    """A chunk of events from one camera (host arrays sorted by time)."""

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
        """Events with t in [t0, t1], by binary search on the host times."""
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


def _stage_weights(w: np.ndarray, n: int) -> None:
    """The bucket pad's per-event weights: 1 for the chunk's n events, 0 for
    the padding."""
    w[:n] = 1.0
    w[n:] = 0.0


def _stage(events: Events, x: np.ndarray, y: np.ndarray, t: np.ndarray,
           w: Optional[np.ndarray]) -> None:
    """Write the chunk into the host buffers x, y (int32), t (float32) and,
    under pad="bucket", w (float32): the tail past the chunk's events holds
    zero-weight events at pixel (0, 0) and the last event's time."""
    n = events.num
    x[:n] = events.x
    x[n:] = 0
    y[:n] = events.y
    y[n:] = 0
    t[:n] = events.t
    t[n:] = t[n - 1]
    if w is not None:
        _stage_weights(w, n)


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


def _host_events(events: Events, packet_size: int, pad: str, device):
    """The chunk as device tensors (x, y, t, w or None), from pageable host
    buffers: the eager path's staging."""
    n = _n_static(events.num, packet_size, pad)
    bufs = (np.empty(n, np.int32), np.empty(n, np.int32), np.empty(n, np.float32),
            np.empty(n, np.float32) if pad == "bucket" else None)
    _stage(events, *bufs)
    return tuple(None if b is None else torch.as_tensor(b, device=device) for b in bufs)


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
    x, y, t, w = _host_events(events, packet_size, pad, traj.device)
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


class Program:
    """The body for one key, captured in a CUDA graph (`graphs.Graph`).

    It owns the body's static inputs on the card (events, weights, poses,
    T_rv_w), the mapper's constants, the pinned buffers the events are
    staged through (`graphs.Staging`), and the graph with its output."""

    def __init__(self, key: tuple, mapper: Mapper, body: _Body, n_static: int,
                 weighted: bool, traj: trajmod.Trajectory):
        dev = traj.device
        self.key, self.body, self.device = key, body, dev
        self.constants = _constants(mapper, body, dev)
        # The key holds the ids of the pose buffer (and the LUT): keep them
        # alive, so that no other object takes those ids while this lives.
        self._pinned_ids = (traj.poses.t, mapper.lut)
        i32, f32 = dict(dtype=torch.int32), dict(dtype=torch.float32)
        self.events = [torch.zeros(n_static, **i32, device=dev),
                       torch.zeros(n_static, **i32, device=dev),
                       torch.zeros(n_static, **f32, device=dev)]
        if weighted:
            self.events.append(torch.zeros(n_static, **f32, device=dev))
        self.staging = graphs.Staging(self.events)
        self.poses = [torch.zeros_like(traj.ts), torch.zeros_like(traj.poses.q),
                      torch.zeros_like(traj.poses.t)]
        self.T_rv_w = [torch.zeros(4, **f32, device=dev), torch.zeros(3, **f32, device=dev)]
        self.graph: Optional[graphs.Graph] = None
        self.capture_s = 0.0

    def _load(self, events: Events, traj: trajmod.Trajectory, T_rv_w: SE3) -> None:
        """Stage the call's inputs into the static buffers on the current
        stream: events through the pinned buffers not in flight."""
        self.staging.load(lambda host: _stage(events, *host, *([None] * (4 - len(host)))))
        for dst, src in zip(self.poses, (traj.ts, traj.poses.q, traj.poses.t)):
            dst.copy_(src)
        self.T_rv_w[0].copy_(T_rv_w.q.reshape(4))
        self.T_rv_w[1].copy_(T_rv_w.t.reshape(3))

    def _run(self) -> torch.Tensor:
        x, y, t = self.events[:3]
        w = self.events[3] if len(self.events) > 3 else None
        traj = trajmod.Trajectory(self.poses[0], SE3(self.poses[1], self.poses[2]))
        return _vote(self.body, self.constants, x, y, t, w, traj, SE3(*self.T_rv_w))

    def capture(self, events: Events, traj: trajmod.Trajectory, T_rv_w: SE3,
                flag: torch.Tensor) -> torch.Tensor:
        """First use: stage the inputs, run the body eagerly
        (`graphs.warm_up`), then capture it.  Returns the eager run's DSI;
        the counts of its launches stand."""
        t0 = time.perf_counter()
        self._load(events, traj, T_rv_w)
        dsi = graphs.warm_up(self.device, self._run, flag)
        self.graph = graphs.Graph(self.device, self._run, flag)
        self.capture_s = time.perf_counter() - t0
        return dsi

    def __call__(self, events: Events, traj: trajmod.Trajectory, T_rv_w: SE3) -> torch.Tensor:
        """Stage, replay on the current stream, and copy the output into a
        fresh DSI."""
        self._load(events, traj, T_rv_w)
        self.graph.replay()
        return self.graph.out.clone()

    def close(self) -> None:
        """Drop the graph and its buffers once the card is done with them."""
        if self.graph is not None:
            torch.cuda.synchronize(self.device)
        self.graph = None


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
    n_static = _n_static(events.num, packet_size, pad)
    body = _setup(mapper, packet_size, backend, plane_block, rectify)
    dev = traj.device
    flag = graphs.fault_flag(dev)
    if graphs.use_programs(dev):
        key = program_key(mapper, events.num, traj, packet_size, backend, plane_block,
                          rectify, pad)
        prog = _PROGRAMS.get(key)
        if prog is None:
            prog = Program(key, mapper, body, n_static, pad == "bucket", traj)
            dsi = prog.capture(events, traj, T_rv_w, flag)
            _PROGRAMS.put(key, prog)
        else:
            dsi = prog(events, traj, T_rv_w)
    else:
        x, y, t, w = _host_events(events, packet_size, pad, dev)
        with binning.deferred_weight_checks(flag):
            dsi = _vote(body, _constants(mapper, body, dev), x, y, t, w, traj, T_rv_w)
    graphs.mark_pending(dev)
    return dsi


def get_depth_map(mapper: Mapper, dsi: torch.Tensor,
                  options: extract.DepthMapOptions) -> extract.DepthMapResult:
    """getDepthMapFromDSI on this mapper's depth planes.  Raises, once the
    extraction is queued, if a chunk voted since the last check had refused
    weights (`check_faults`)."""
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
