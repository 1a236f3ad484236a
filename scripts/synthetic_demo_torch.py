#!/usr/bin/env python
"""End-to-end synthetic-scene drive of the public dvs_mcemvs_torch API.

Port of scripts/synthetic_demo.py: generates events analytically from a
rigid two-plane scene observed by a moving stereo event-camera rig (the
same scene, events and numpy seed), then runs the mapping pipeline --
trajectory interpolation, event warp to the z0 plane, DSI voting, stereo
fusion, depth-map extraction, point cloud -- and checks the recovered
semi-dense depths against ground truth.  Prints a JSON report and
PASS/FAIL; the exit code is 0/1.

Runs on the CUDA device unless `--device cpu` is given (the kernels then
run through their plain versions); without a card it raises.

Usage: python scripts/synthetic_demo_torch.py [--backend SPEC] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dvs_mcemvs_torch.device import require_cuda  # noqa: E402
from dvs_mcemvs_torch.ops import extract, grid, pointcloud, se3, trajectory, voting  # noqa: E402
from dvs_mcemvs_torch.ops.camera import PinholeCamera, rectify_lut, virtual_camera  # noqa: E402
from dvs_mcemvs_torch.ops.depth_vector import LINEAR, DepthVector  # noqa: E402
from dvs_mcemvs_torch.ops.se3 import SE3  # noqa: E402

SEED = 42


def make_scene(rng, n_pts=4000):
    """Two fronto-parallel planes in the world frame: left half at 1.5 m,
    right half at 2.5 m (depths measured along +z from the rig start)."""
    x = rng.uniform(-1.2, 1.2, n_pts)
    y = rng.uniform(-0.9, 0.9, n_pts)
    z = np.where(x < 0.0, 1.5, 2.5)
    return np.stack([x, y, z], axis=-1)


def simulate_events(pts_w, cam, cam_positions, t_samples, rng):
    """Project scene points through a translating camera at each sample time;
    each visible projection becomes one event (integer pixel)."""
    xs, ys, ts = [], [], []
    for tk, p in zip(t_samples, cam_positions):
        rel = pts_w - p[None, :]
        z = rel[:, 2]
        u = cam.fx * rel[:, 0] / z + cam.cx
        v = cam.fy * rel[:, 1] / z + cam.cy
        ok = (z > 0.1) & (u >= 0) & (u < cam.width - 1) & (v >= 0) & (v < cam.height - 1)
        xs.append(np.round(u[ok]).astype(np.int32))
        ys.append(np.round(v[ok]).astype(np.int32))
        ts.append(np.full(ok.sum(), tk, dtype=np.float64))
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    t = np.concatenate(ts)
    # Shuffle within small windows to mimic sensor jitter, then stable-sort.
    order = np.argsort(t + rng.uniform(0, 1e-4, t.shape), kind="stable")
    return x[order], y[order], t[order].astype(np.float32)


def rig_events(rng, cam, baseline):
    """The scene and both cameras' events, drawn from `rng` in the JAX
    demo's order."""
    pts = make_scene(rng)
    t_samp = np.linspace(0.05, 0.95, 40)

    def pos_at(tt, off):
        return np.stack([0.40 * tt + off, 0.0 * tt, 0.0 * tt], axis=-1)

    ev0 = simulate_events(pts, cam, pos_at(t_samp, 0.0), t_samp, rng)
    ev1 = simulate_events(pts, cam, pos_at(t_samp, baseline), t_samp, rng)
    return ev0, ev1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="scatter",
                    help="splat backend spec (see voting.resolve_backend): "
                         "scatter, sort, hist, hist_exact, hist:g16,seg16,bf,pl, ...")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the pipeline runs (cuda raises without a card)")
    args = ap.parse_args(argv)
    dev = require_cuda() if args.device == "cuda" else torch.device("cpu")
    rng = np.random.default_rng(SEED)

    W, H = 128, 96
    cam = PinholeCamera(width=W, height=H, fx=120.0, fy=120.0, cx=64.0, cy=48.0)
    baseline = 0.20  # stereo rig: cam1 shifted +x by 20 cm

    # Rig trajectory: translate along +x by 40 cm over 1 s (identity rotation).
    n_pose = 50
    t_pose = np.linspace(0.0, 1.0, n_pose)
    pos0 = np.stack([0.40 * t_pose, np.zeros(n_pose), np.zeros(n_pose)], axis=-1)
    quat = np.tile([1.0, 0.0, 0.0, 0.0], (n_pose, 1))
    traj0 = trajectory.from_arrays(t_pose, quat, pos0, device=dev)
    traj1 = trajectory.apply_right(
        traj0, SE3(torch.tensor([1.0, 0, 0, 0], device=dev),
                   torch.tensor([baseline, 0, 0], device=dev)))

    ev0, ev1 = rig_events(rng, cam, baseline)
    print(f"events: cam0={len(ev0[0])}, cam1={len(ev1[0])}")

    # Reference view at the rig midpoint (left camera pose at ts=0.5).
    ts_ref = 0.5
    T_w_rv, _ = trajectory.pose_at(traj0, np.float32(ts_ref))
    T_rv_w = se3.inverse(T_w_rv)

    dv = DepthVector(LINEAR, 1.0, 4.0, 64)
    depths = dv.depths()
    vcam = virtual_camera(W, H, 0.0, cam)
    lut = torch.as_tensor(rectify_lut(cam), device=dev)
    K_cam = torch.as_tensor(cam.P.astype(np.float32), device=dev)
    Kv_inv = torch.as_tensor(np.linalg.inv(vcam.P).astype(np.float32), device=dev)

    t0 = time.time()
    dsis = []
    for (x, y, t), trj in [(ev0, traj0), (ev1, traj1)]:
        packets = voting.warp_events_to_z0(
            torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev),
            torch.as_tensor(t, device=dev), trj, T_rv_w, lut, K_cam, Kv_inv,
            z0=float(depths[0]), width=W, packet_size=256)
        dsis.append(voting.vote_dsi(packets, depths, vcam, backend=args.backend))
    fused = grid.fuse_pair(dsis[0], dsis[1], grid.FUSE_HM)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.time()
    print(f"voting+fusion: {t1 - t0:.2f}s  DSI meansq={float(grid.mean_square(fused)):.3f}")

    opts = extract.DepthMapOptions(
        adaptive_threshold_kernel_size=5, adaptive_threshold_c=5.0, median_filter_size=5)
    res = extract.get_depth_map_from_dsi(fused, dv, opts)
    mask = res.mask.cpu().numpy() > 0
    depth = res.depth.cpu().numpy()

    # Ground truth in the RV frame: plane depth is world z (the RV has the
    # identity rotation and z-translation 0); the RV centre is at world
    # x = 0.40 * 0.5 = 0.20, so a pixel ray at depth z meets world
    # x = (u - cx) / fx * z + 0.20.
    ys, xs = np.nonzero(mask)
    d = depth[ys, xs]
    x_w = (xs - vcam.cx) / vcam.fx * d + 0.20
    gt = np.where(x_w < 0.0, 1.5, 2.5)
    err = np.abs(d - gt)
    # Exclude pixels near the split between the planes.
    plane_step = (4.0 - 1.0) / 64
    core = np.abs(x_w) > 0.05
    med_err = float(np.median(err[core]))
    mean_err = float(np.mean(err[core]))
    frac_bad = float(np.mean(err[core] > 3 * plane_step))
    n_pix = int(mask.sum())

    pc = pointcloud.depth_map_to_pointcloud(depth, mask, vcam)
    pc_f = pointcloud.radius_outlier_removal(pc, radius=0.3, min_neighbors=3)

    report = {
        "backend": args.backend,
        "semi_dense_pixels": n_pix,
        "median_abs_err_m": round(med_err, 4),
        "mean_abs_err_m": round(mean_err, 4),
        "frac_err_gt_3planes": round(frac_bad, 4),
        "plane_step_m": round(plane_step, 4),
        "pointcloud_raw": int(pc.xyz.shape[0]),
        "pointcloud_filtered": int(pc_f.xyz.shape[0]),
    }
    print(json.dumps(report))

    ok = (
        n_pix > 500
        and med_err <= plane_step  # within one depth-plane spacing
        and frac_bad < 0.15
        and pc_f.xyz.shape[0] > 0
    )
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
