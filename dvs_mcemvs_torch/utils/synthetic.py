"""Synthetic stereo event-camera rig: analytic scenes with exact ground truth.

Port of dvs_mcemvs_tpu/utils/synthetic.py (pure numpy, float64, so the two
packages generate identical events from one seed): a rigid two-plane point
scene observed by a rig translating along +x produces one event per
(point, sample time) visibility.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..mapper import Events
from ..ops.camera import PinholeCamera


@dataclasses.dataclass(frozen=True)
class SyntheticRig:
    """ESIM-like stereo rig moving along +x with two scene planes."""

    cam: PinholeCamera
    baseline: float
    travel: float        # total +x translation over [0, 1] s
    plane_depths: Tuple[float, float]
    split_x: float = 0.0  # world-x boundary between the two planes

    def camera_position(self, t, cam_index: int = 0) -> np.ndarray:
        """Camera `cam_index` sits at +cam_index*baseline along the rig's x."""
        t = np.asarray(t, np.float64)
        off = self.baseline * cam_index
        return np.stack([self.travel * t + off, 0.0 * t, 0.0 * t], axis=-1)


def esim_like_rig(travel: float = 0.4) -> SyntheticRig:
    """240x180, f=200, baseline 0.2 m: the reference's ESIM calibration."""
    cam = PinholeCamera(width=240, height=180, fx=200.0, fy=200.0, cx=120.0, cy=90.0)
    return SyntheticRig(cam=cam, baseline=0.2, travel=travel, plane_depths=(1.5, 2.5))


def make_scene(rig: SyntheticRig, rng: np.random.Generator, n_pts: int = 4000) -> np.ndarray:
    """Random points on two fronto-parallel planes split at `split_x`."""
    x = rng.uniform(-1.2, 1.2 + rig.travel, n_pts)
    y = rng.uniform(-0.9, 0.9, n_pts)
    z = np.where(x < rig.split_x, rig.plane_depths[0], rig.plane_depths[1])
    return np.stack([x, y, z], axis=-1)


def simulate_events(
    rig: SyntheticRig,
    pts_w: np.ndarray,
    cam_index: int,
    n_samples: int = 40,
    t_range: Tuple[float, float] = (0.05, 0.95),
    rng: Optional[np.random.Generator] = None,
) -> Events:
    """One event per visible (point, sample time); integer pixels, sorted t."""
    rng = rng or np.random.default_rng(0)
    cam = rig.cam
    t_samples = np.linspace(t_range[0], t_range[1], n_samples)
    xs, ys, ts, ps = [], [], [], []
    for tk in t_samples:
        p = rig.camera_position(tk, cam_index)
        rel = pts_w - p[None, :]
        z = rel[:, 2]
        u = cam.fx * rel[:, 0] / z + cam.cx
        v = cam.fy * rel[:, 1] / z + cam.cy
        ok = (z > 0.1) & (u >= 0) & (u < cam.width - 1) & (v >= 0) & (v < cam.height - 1)
        xs.append(np.round(u[ok]).astype(np.int32))
        ys.append(np.round(v[ok]).astype(np.int32))
        ts.append(np.full(int(ok.sum()), tk))
        ps.append((rng.uniform(size=int(ok.sum())) > 0.5).astype(np.int8))
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    t = np.concatenate(ts)
    p = np.concatenate(ps)
    order = np.argsort(t + rng.uniform(0, 1e-4, t.shape), kind="stable")
    return Events(x[order], y[order], t[order], p[order])


def rig_poses(rig: SyntheticRig, n: int = 50) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(t, q_wxyz, p_xyz) of the left camera over [0, 1] s."""
    ts = np.linspace(0.0, 1.0, n)
    q = np.tile([1.0, 0.0, 0.0, 0.0], (n, 1))
    p = rig.camera_position(ts, 0)
    return ts, q, p


def ground_truth_depth(
    rig: SyntheticRig, vcam: PinholeCamera, rv_x: float,
    xs: np.ndarray, ys: np.ndarray, depth: np.ndarray,
) -> np.ndarray:
    """Analytic depth per pixel: plane membership from the world-x of each
    pixel's ray at the recovered depth."""
    x_w = (xs - vcam.cx) / vcam.fx * depth + rv_x
    return np.where(x_w < rig.split_x, rig.plane_depths[0], rig.plane_depths[1])
