"""Per-camera EMVS mapper: DSI setup, event back-projection, extraction.

Port of dvs_mcemvs_tpu/mapper.py: an immutable per-camera setup (virtual
camera, rectification LUT, depth planes) whose `evaluate_dsi` turns a chunk
of events into a fresh (Z, H, W) DSI on the device of the trajectory, and
`get_pointcloud`, which turns a depth map into a filtered point cloud.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .ops import camera as camops, extract, pointcloud as pcops, trajectory as trajmod, voting
from .ops.camera import PinholeCamera, rectify_lut, virtual_camera
from .ops.depth_vector import DepthVector, LINEAR
from .ops.se3 import SE3


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
    """Smallest power-of-two packet count covering n events, in events."""
    k = -(-n // packet_size)
    return packet_size * (1 << max(k - 1, 0).bit_length())


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
    on the trajectory's device: (packets, plane depths, z0).  `rectify` and
    `pad` as in `evaluate_dsi`."""
    dev = traj.device
    ev_weight = None
    x_arr, y_arr, t_arr = events.x, events.y, events.t
    if pad == "bucket":
        cap = bucket_capacity(events.num, packet_size)
        extra = cap - events.num
        x_arr = np.pad(np.asarray(x_arr), (0, extra))
        y_arr = np.pad(np.asarray(y_arr), (0, extra))
        t_arr = np.pad(np.asarray(t_arr), (0, extra), mode="edge")
        w = np.zeros(cap, np.float32)
        w[:events.num] = 1.0
        ev_weight = torch.as_tensor(w, device=dev)
    elif pad != "none":
        raise ValueError(f"pad must be 'none' or 'bucket', got {pad!r}")
    if rectify not in ("device", "lut"):
        raise ValueError(f"rectify must be 'device' or 'lut', got {rectify!r}")
    depths_np = mapper.depth_vec.depths()
    depths = torch.as_tensor(depths_np, device=dev)
    z0 = float(depths_np[0])
    K_cam = torch.as_tensor(mapper.cam.P.astype(np.float32), device=dev)
    Kv_inv = torch.as_tensor(np.linalg.inv(mapper.vcam.P).astype(np.float32), device=dev)
    rect_params = camops.rect_static(mapper.cam) if rectify == "device" else None
    lut = None if rect_params is not None else torch.as_tensor(mapper.lut, device=dev)
    packets = voting.warp_events_to_z0(
        torch.as_tensor(np.asarray(x_arr, np.int32), device=dev),
        torch.as_tensor(np.asarray(y_arr, np.int32), device=dev),
        torch.as_tensor(np.asarray(t_arr, np.float32), device=dev),
        traj, T_rv_w, lut, K_cam, Kv_inv, z0=z0, width=mapper.width,
        packet_size=packet_size, rect_params=rect_params,
        ev_weight=ev_weight, full=ev_weight is not None,
    )
    return packets, depths, z0


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
    """
    if events.num <= packet_size:
        return None
    packets, depths, z0 = warp_chunk(mapper, events, traj, T_rv_w, packet_size,
                                     rectify, pad)
    vp = (float(mapper.vcam.fx), float(mapper.vcam.fy),
          float(mapper.vcam.cx), float(mapper.vcam.cy))
    fn = voting.resolve_backend(backend)
    return fn(packets, depths, z0, vp, mapper.width, mapper.height,
              plane_block=plane_block)


def get_depth_map(mapper: Mapper, dsi: torch.Tensor,
                  options: extract.DepthMapOptions) -> extract.DepthMapResult:
    """getDepthMapFromDSI on this mapper's depth planes."""
    return extract.get_depth_map_from_dsi(dsi, mapper.depth_vec, options)


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
