#!/usr/bin/env python
"""Convert pose files between formats (TUM txt / npz / rosbag -> npz or TUM)
through dvs_mcemvs_torch -- the port of scripts/convert_poses.py, writing
the same bytes.

The poses go through the port's `io.poses.read_poses`, so they are sorted
by time and stored as float32 (times too), as every pipeline entry point
reads them.  npz pose stores hold `t`, `q` (wxyz) and `p`.

The trajectory is built on the CUDA device unless `--device cpu` is given;
without a card the default raises.

Usage:
  python scripts/convert_poses_torch.py mocap.txt poses.npz
  python scripts/convert_poses_torch.py pose.bag poses.npz --topic /pose
  python scripts/convert_poses_torch.py poses.npz poses.txt --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dvs_mcemvs_torch.device import require_cuda  # noqa: E402
from dvs_mcemvs_torch.io import poses as posesio  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help=".txt (TUM), .npz, or .bag pose file")
    ap.add_argument("dst", help="output .npz or .txt (TUM)")
    ap.add_argument("--topic", default="", help="pose topic for rosbag input")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the trajectory is built (cuda raises without a card)")
    args = ap.parse_args(argv)
    if not args.dst.endswith((".npz", ".txt")):
        raise SystemExit(f"unsupported output format: {args.dst}")
    device = require_cuda() if args.device == "cuda" else "cpu"

    traj = posesio.read_poses(args.src, topic=args.topic, device=device)
    ts = traj.ts.cpu().numpy().astype(np.float64)
    q = traj.poses.q.cpu().numpy().astype(np.float64)  # wxyz
    p = traj.poses.t.cpu().numpy().astype(np.float64)

    if args.dst.endswith(".npz"):
        np.savez(args.dst, t=ts, q=q, p=p)
    else:
        q_xyzw = q[:, [1, 2, 3, 0]]
        with open(args.dst, "w") as f:
            f.write("# t x y z qx qy qz qw\n")
            for i in range(len(ts)):
                f.write("%.9f %.6f %.6f %.6f %.9f %.9f %.9f %.9f\n" % (
                    ts[i], *p[i], *q_xyzw[i]))
    print(f"wrote {args.dst} ({len(ts)} poses)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
