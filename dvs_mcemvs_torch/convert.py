"""Carry state across from the JAX package to the port.

The system has no learned weights; its state is the per-camera setup, the
trajectories, the reference-view pose and the intermediates of a chunk.
Each function takes the JAX package's object (or anything with the same
fields whose arrays `np.asarray` can read) and returns the port's object on
`device`: the card when it is None (raising when there is none), the CPU
only when the caller passes `device="cpu"`.  Nothing here imports JAX: the
arrays are read through numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .device import require_cuda
from .mapper import Events, Mapper
from .ops.camera import PinholeCamera
from .ops.depth_vector import DepthVector
from .ops.se3 import SE3
from .ops.trajectory import Trajectory
from .ops.voting import WarpedPackets


def tensor(a, device=None, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host or JAX array as a tensor on `device` (a copy, never a view)."""
    if device is None:
        device = require_cuda()
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def se3(T, device=None) -> SE3:
    return SE3(tensor(T.q, device, torch.float32), tensor(T.t, device, torch.float32))


def trajectory(traj, device=None) -> Trajectory:
    return Trajectory(tensor(traj.ts, device, torch.float32), se3(traj.poses, device))


def camera(cam) -> PinholeCamera:
    return PinholeCamera(**dataclasses.asdict(cam))


def mapper(m) -> Mapper:
    dv = m.depth_vec
    return Mapper(cam=camera(m.cam), vcam=camera(m.vcam),
                  depth_vec=DepthVector(dv.kind, dv.min_depth, dv.max_depth, dv.n),
                  lut=np.asarray(m.lut, np.float32))


def events(ev) -> Events:
    return Events(np.asarray(ev.x), np.asarray(ev.y), np.asarray(ev.t),
                  None if ev.p is None else np.asarray(ev.p))


def packets(p, device=None) -> WarpedPackets:
    return WarpedPackets(
        tensor(p.xy_z0, device, torch.float32), tensor(p.centers, device, torch.float32),
        tensor(p.valid, device, torch.bool),
        None if p.weight is None else tensor(p.weight, device, torch.float32))
