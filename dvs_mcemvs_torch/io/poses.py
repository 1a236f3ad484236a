"""Pose-stream readers -> `Trajectory`.

Port of dvs_mcemvs_tpu/io/poses.py: TUM trajectory text files, npz arrays
and ROS1 bags (the four pose message types of data_loading.cpp:334-463),
read on the host and placed on `device` (the card when None, raising
without one; "cpu" for the CPU), as `ops.trajectory.from_arrays` does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..ops import trajectory as trajmod
from .events import TimeOrigin


def _build(ts, q_wxyz, t_xyz, t_start, t_stop, origin, device) -> trajmod.Trajectory:
    ts = np.asarray(ts, np.float64)
    if origin is not None:
        ts = origin.normalize(ts)
    keep = (ts >= t_start) & (ts <= t_stop)
    return trajmod.from_arrays(ts[keep], np.asarray(q_wxyz)[keep], np.asarray(t_xyz)[keep],
                               device=device)


def read_poses_tum(
    path: str,
    t_start: float = -1e19,
    t_stop: float = 1e19,
    origin: Optional[TimeOrigin] = None,
    device=None,
) -> trajmod.Trajectory:
    """TUM format: `t x y z qx qy qz qw` per line (the output of the
    reference's scripts/mocap_txt2bag.py converter, inverted)."""
    data = np.loadtxt(path, comments="#")
    if data.ndim == 1:
        data = data[None, :]
    ts = data[:, 0]
    t_xyz = data[:, 1:4]
    q_xyzw = data[:, 4:8]
    q_wxyz = q_xyzw[:, [3, 0, 1, 2]]
    return _build(ts, q_wxyz, t_xyz, t_start, t_stop, origin, device)


def read_poses_npz(
    path: str,
    t_start: float = -1e19,
    t_stop: float = 1e19,
    origin: Optional[TimeOrigin] = None,
    device=None,
) -> trajmod.Trajectory:
    """npz with `t` (N,), and either `q` (N,4 wxyz) + `p` (N,3) or
    `T` (N,4,4) homogeneous matrices."""
    data = np.load(path)
    ts = np.asarray(data["t"], np.float64)
    if "T" in data:
        mats = np.asarray(data["T"], np.float64)
        if origin is not None:
            ts = origin.normalize(ts)
        keep = (ts >= t_start) & (ts <= t_stop)
        return trajmod.from_matrices(ts[keep], mats[keep], device=device)
    return _build(ts, data["q"], data["p"], t_start, t_stop, origin, device)


def read_poses_rosbag(
    path: str,
    topic: str,
    t_start: float = -1e19,
    t_stop: float = 1e19,
    origin: Optional[TimeOrigin] = None,
    device=None,
) -> trajmod.Trajectory:
    """The pose messages on `topic` of a ROS1 bag ("" = the bag's pose
    messages on any topic), through `io/rosbag1.py`."""
    from . import rosbag1

    ts, qs, ps = rosbag1.read_pose_bag(path, topic)
    return _build(ts, qs, ps, t_start, t_stop, origin, device)


def read_poses(path: str, topic: str = "", **kwargs) -> trajmod.Trajectory:
    """Dispatch on file extension; `topic` names a bag's pose topic."""
    if path.endswith(".bag"):
        return read_poses_rosbag(path, topic, **kwargs)
    if path.endswith(".npz"):
        return read_poses_npz(path, **kwargs)
    return read_poses_tum(path, **kwargs)
