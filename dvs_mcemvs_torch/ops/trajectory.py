"""Time-indexed SE(3) trajectory with vectorized linear interpolation.

Port of dvs_mcemvs_tpu/ops/trajectory.py: a sorted pose buffer queried by a
batched `searchsorted` + batched SE(3) lerp.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import require_cuda
from . import se3
from .se3 import SE3


class Trajectory(NamedTuple):
    """Sorted pose buffer: ts (N,) float32 seconds, poses: SE3 with batch (N,).

    `span` holds ts[0] and ts[-1] as host floats of ts's dtype when they
    were known on the host (`from_arrays` and the functions that derive a
    trajectory from one), so that `valid_at` needs no device read.
    """

    ts: torch.Tensor
    poses: SE3
    span: Optional[Tuple[float, float]] = None

    @property
    def n(self) -> int:
        return int(self.ts.shape[0])

    @property
    def device(self) -> torch.device:
        return self.ts.device

    @property
    def t_start(self) -> torch.Tensor:
        return self.ts[0]

    @property
    def t_end(self) -> torch.Tensor:
        return self.ts[-1]


def from_arrays(ts, qs, trans, device=None) -> Trajectory:
    """Build from arrays; ts (N,), qs (N,4) wxyz, trans (N,3); sorted by time.

    The tensors go to `device`, by default the CUDA device (raises when there
    is none); pass device="cpu" for the CPU.
    """
    if device is None:
        device = require_cuda()
    ts_host = np.asarray(ts, np.float32)
    ts = torch.as_tensor(ts_host, device=device)
    order = torch.argsort(ts, stable=True)
    q = torch.as_tensor(se3.quat_normalize_host(qs), device=device)[order]
    t = torch.as_tensor(np.asarray(trans, np.float32), device=device)[order]
    span = (float(ts_host.min()), float(ts_host.max())) if ts_host.size else None
    return Trajectory(ts[order], SE3(q, t), span)


def from_matrices(ts, mats, device=None) -> Trajectory:
    """Build from (N, 4, 4) homogeneous matrices; `device` as in from_arrays."""
    mats = torch.as_tensor(np.asarray(mats, np.float32))
    return from_arrays(ts, se3.matrix_to_quat(mats[..., :3, :3]).numpy(),
                       mats[..., :3, 3].numpy(), device=device)


def pose_at(traj: Trajectory, t) -> Tuple[SE3, torch.Tensor]:
    """Interpolated pose at query times t (...,).

    Returns (SE3 with the batch shape of t, valid mask).  Queries outside
    [ts[0], ts[-1]] are invalid (no extrapolation); their pose is clamped to
    the nearest segment and must be masked by callers.
    """
    t = torch.as_tensor(t, dtype=traj.ts.dtype, device=traj.ts.device)
    # upper_bound(t): first index with ts > t.
    it1 = torch.searchsorted(traj.ts, t.reshape(-1), right=True).reshape(t.shape)
    valid = (it1 > 0) & (it1 < traj.n)
    i1 = torch.clamp(it1, 1, traj.n - 1)
    i0 = i1 - 1
    t0, t1 = traj.ts[i0], traj.ts[i1]
    T0 = SE3(traj.poses.q[i0], traj.poses.t[i0])
    T1 = SE3(traj.poses.q[i1], traj.poses.t[i1])
    alpha = (t - t0) / torch.clamp(t1 - t0, min=1e-12)
    return se3.interpolate(T0, T1, alpha), valid


def valid_at(traj: Trajectory, t: float) -> bool:
    """Whether `pose_at(traj, t)` calls time `t` valid, decided on the host
    as it decides it: t rounded to ts's dtype lies in [ts[0], ts[-1]).  Reads
    ts[0] and ts[-1] from the device only for a trajectory without `span`."""
    lo, hi = traj.span if traj.span is not None else traj.ts[[0, -1]].tolist()
    t32 = np.float32(t)
    return bool(np.float32(lo) <= t32 < np.float32(hi))


def apply_right(traj: Trajectory, T: SE3) -> Trajectory:
    """Right-compose every pose with a fixed transform: T_i <- T_i * T."""
    q = T.q.expand(traj.poses.q.shape)
    t = T.t.expand(traj.poses.t.shape)
    return Trajectory(traj.ts, se3.compose(traj.poses, SE3(q, t)), traj.span)


def apply_left(traj: Trajectory, T: SE3) -> Trajectory:
    """Left-compose every pose: T_i <- T * T_i."""
    q = T.q.expand(traj.poses.q.shape)
    t = T.t.expand(traj.poses.t.shape)
    return Trajectory(traj.ts, se3.compose(SE3(q, t), traj.poses), traj.span)


def slice_time(traj: Trajectory, t_start: float, t_stop: float, pad: int = 1) -> Trajectory:
    """Crop to [t_start, t_stop] with `pad` extra poses on each side; the
    bounds are searched in a host copy of `ts`."""
    ts = traj.ts.cpu().numpy()
    lo = max(0, int(np.searchsorted(ts, t_start, side="left")) - pad)
    hi = min(len(ts), int(np.searchsorted(ts, t_stop, side="right")) + pad)
    span = (float(ts[lo]), float(ts[hi - 1])) if hi > lo else None
    return Trajectory(traj.ts[lo:hi], SE3(traj.poses.q[lo:hi], traj.poses.t[lo:hi]), span)
