#!/usr/bin/env python
"""Runnable DSEC evaluation on dvs_mcemvs_torch -- the port of
scripts/evaluate_dsec.py, with its flags and its JSON report; CLI parity
with the reference's `evaluate_mcemvs_dsec.py` (reference:
mapper_emvs_stereo/scripts/evaluate_mcemvs_dsec.py:43-141).

Walks a finished run directory of timestamped `depth_points_<suffix>.txt`
files, matches each to the nearest ground-truth frame (within ±0.1 s),
builds GT depth in the left event camera frame, consolidates all matched
frames into masked arrays, and prints one JSON report with mean/median
error plus the full DepthMetrics set (δ1/2/3, SILog, AbsRel, logRMSE,
bad-p).

Ground truth can come in two forms:
  * --gt_disparity_dir + --calib_dir: DSEC 16-bit disparity PNGs reprojected
    through the rig's Q / R_rect0 (the reference protocol).
  * --gt_depth_npy_dir: per-frame metric depth .npy maps in the event-camera
    frame already (synthetic fixtures, other datasets).

The evaluation is numpy on the host: it needs no card.

Usage:
  python scripts/evaluate_dsec_torch.py --run_dir out/ --suffix fused \
      --gt_disparity_dir .../disparity_event --gt_timestamps .../timestamps.txt \
      --calib_dir .../calibration --fx 557.2 --cx 320 --cy 240 \
      --event_start_time 36470.59968
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dvs_mcemvs_torch.eval import dsec as dsecmod  # noqa: E402


def find_run_frames(run_dir: str, suffix: str):
    """(time, path) pairs of `<%013.9f>depth_points_<suffix>.txt` files —
    the reference walks `inv_depth_colored_dilated_*` PNGs to discover
    timestamps (evaluate_mcemvs_dsec.py:87-94); the txt files are the
    canonical artifact so they are walked directly here."""
    pat = re.compile(r"^(\d+\.\d+)depth_points_" + re.escape(suffix) + r"\.txt$")
    frames = []
    for f in sorted(os.listdir(run_dir)):
        m = pat.match(f)
        if m:
            frames.append((float(m.group(1)), os.path.join(run_dir, f)))
    return frames


def _read_disparity_png(path: str) -> np.ndarray:
    """DSEC disparity PNGs are uint16 with a 1/256 px scale; the reference
    reads them with plt.imread (float in [0,1]) and multiplies by 256
    (evaluate_mcemvs_dsec.py:110) — net effect: disp_px = uint16 / 256."""
    try:
        import cv2

        raw = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    except ImportError:
        from PIL import Image

        raw = np.asarray(Image.open(path))
    return raw.astype(np.float32) / 256.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--run_dir", required=True)
    ap.add_argument("--suffix", default="fused")
    ap.add_argument("--gt_timestamps", required=True,
                    help="txt of GT frame timestamps in microseconds")
    ap.add_argument("--gt_disparity_dir", default="",
                    help="DSEC disparity PNGs named <2*frame_id:06d>.png")
    ap.add_argument("--gt_depth_npy_dir", default="",
                    help="alternative GT: per-frame depth .npy named <frame_id:06d>.npy")
    ap.add_argument("--calib_dir", default="",
                    help="dir containing cam_to_cam.yaml (disparity mode)")
    ap.add_argument("--fx", type=float, default=0.0,
                    help="left event camera rectified focal (disparity mode)")
    ap.add_argument("--fy", type=float, default=0.0)
    ap.add_argument("--cx", type=float, default=0.0)
    ap.add_argument("--cy", type=float, default=0.0)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--baseline", type=float, default=0.6)
    ap.add_argument("--event_start_time", type=float, default=0.0,
                    help="absolute time (s) of the run's t=0 (DSEC: first event ts)")
    ap.add_argument("--start", type=float, default=-np.inf)
    ap.add_argument("--stop", type=float, default=np.inf)
    ap.add_argument("--max_dt", type=float, default=0.1)
    ap.add_argument("--thicken_edges", action="store_true",
                    help="3x3 ellipse erosion of the rasterized depth "
                         "points (evaluate_mcemvs_dsec.py:64-77; off by "
                         "default there too)")
    args = ap.parse_args(argv)

    frames = find_run_frames(args.run_dir, args.suffix)
    frames = [(t, p) for t, p in frames if args.start <= t <= args.stop]
    if not frames:
        print(json.dumps({"error": "no depth_points files found"}))
        return 1

    gt_ts_us = np.loadtxt(args.gt_timestamps).reshape(-1)
    shape = (args.height, args.width)

    rig = None
    if args.gt_disparity_dir:
        if not (args.calib_dir and args.fx):
            ap.error("--gt_disparity_dir needs --calib_dir and --fx/--cx/--cy")
        K = np.array([[args.fx, 0, args.cx],
                      [0, args.fy or args.fx, args.cy],
                      [0, 0, 1.0]])
        rig = dsecmod.load_eval_rig_yaml(
            os.path.join(args.calib_dir, "cam_to_cam.yaml"), K,
            baseline=args.baseline)
    else:
        # Metrics still need (b, f) for bad-p; take f from --fx if given.
        K = np.array([[args.fx or 1.0, 0, args.cx],
                      [0, args.fy or args.fx or 1.0, args.cy],
                      [0, 0, 1.0]])
        rig = dsecmod.DsecEvalRig(Q=np.eye(4), T_rect0_0=np.eye(4),
                                  K_target=K, baseline=args.baseline)

    pairs = dsecmod.match_timestamps(
        [t for t, _ in frames], gt_ts_us, args.event_start_time, args.max_dt)

    est_maps, gt_maps, used = [], [], []
    for est_i, gt_j in pairs:
        t, path = frames[est_i]
        if args.gt_disparity_dir:
            gt_file = os.path.join(args.gt_disparity_dir,
                                   f"{gt_j * 2:06d}.png")
            if not os.path.exists(gt_file):
                continue
            gt = dsecmod.disparity_to_depth_map(
                _read_disparity_png(gt_file), rig, shape=shape)
        else:
            gt_file = os.path.join(args.gt_depth_npy_dir, f"{gt_j:06d}.npy")
            if not os.path.exists(gt_file):
                continue
            arr = np.load(gt_file)
            gt = np.ma.array(arr, mask=(arr < 0.05))
        est_maps.append(dsecmod.load_depth_points(
            path, shape, thicken_edges=args.thicken_edges))
        gt_maps.append(gt)
        used.append(t)

    if not est_maps:
        print(json.dumps({"error": "no matched GT frames"}))
        return 1

    report = dsecmod.evaluate_sequence(est_maps, gt_maps, rig)
    out = {
        "suffix": args.suffix,
        "frames_found": len(frames),
        "frames_evaluated": len(est_maps),
        "times": [round(t, 6) for t in used],
        "mean_err": float(report["mean_err"]),
        "median_err": float(report["median_err"]),
    }
    out.update({k: float(v) for k, v in report["metrics"].as_dict().items()})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
