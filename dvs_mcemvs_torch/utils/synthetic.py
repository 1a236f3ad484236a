"""Synthetic stereo event-camera rig: analytic scenes with exact ground truth.

Port of dvs_mcemvs_tpu/utils/synthetic.py (pure numpy, float64, so the two
packages generate identical events from one seed): a rigid two-plane point
scene observed by a rig translating along +x produces one event per
(point, sample time) visibility.  `write_fixture` writes such a rig as a
dataset the CLI reads.
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


def write_fixture(
    out_dir: str, rig: Optional[SyntheticRig] = None, n_pts: int = 3000,
    n_samples: int = 30, seed: int = 7, n_cameras: int = 2,
) -> dict:
    """Write a self-contained CLI-drivable dataset: events npz per camera +
    TUM pose file.  Pairs with calib_type='esim' (stereo); with n_cameras=3
    it also writes a 3-camera 'cameras:' YAML (pairs with calib_type='yaml',
    key 'calib') modelling an inline evimo2-style rig."""
    import os

    from ..io import events as eventsmod

    rig = rig or esim_like_rig()
    rng = np.random.default_rng(seed)
    pts = make_scene(rig, rng)
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for i in range(n_cameras):
        ev = simulate_events(rig, pts, i, n_samples=n_samples, rng=rng)
        paths[f"events{i}"] = os.path.join(out_dir, f"events_{i}.npz")
        eventsmod.write_events_npz(paths[f"events{i}"], ev)
    if n_cameras >= 3:
        paths["calib"] = os.path.join(out_dir, "rig.yaml")
        with open(paths["calib"], "w") as f:
            f.write("cameras:\n")
            for i in range(n_cameras):
                T = np.eye(4)
                T[0, 3] = rig.baseline * i  # T_B_C: cam i in the body frame
                row = ", ".join(f"{v}" for v in T.reshape(-1))
                f.write(
                    f"  - camera:\n"
                    f"      image_width: {rig.cam.width}\n"
                    f"      image_height: {rig.cam.height}\n"
                    f"      intrinsics:\n"
                    f"        data: [{rig.cam.fx}, {rig.cam.fy}, "
                    f"{rig.cam.cx}, {rig.cam.cy}]\n"
                    f"    T_B_C:\n"
                    f"      data: [{row}]\n")
    ts, q, p = rig_poses(rig)
    pose_path = os.path.join(out_dir, "poses_tum.txt")
    with open(pose_path, "w") as f:
        f.write("# t x y z qx qy qz qw\n")
        for k in range(len(ts)):
            f.write(f"{ts[k]} {p[k,0]} {p[k,1]} {p[k,2]} "
                    f"{q[k,1]} {q[k,2]} {q[k,3]} {q[k,0]}\n")
    paths["poses"] = pose_path
    paths["rig"] = rig
    return paths
