"""DSEC ground-truth evaluation protocol.

Port of dvs_mcemvs_tpu/eval/dsec.py, which reimplements the pipeline of
`mapper_emvs_stereo/scripts/evaluate_mcemvs_dsec.py`: GT disparity PNGs ->
depth via the rig's Q matrix -> 3D points -> transform out of the rectified
frame -> project into the (undistortion-corrected) left event camera ->
per-frame sparse GT depth map; estimated depth maps are read from the
framework's `depth_points` txt outputs; frames are matched by timestamp
within 0.1 s (evaluate_mcemvs_dsec.py:104-107) and errors are consolidated
over all matched frames.

Pure numpy on the host, copied from the JAX module so that the port imports
nothing of it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .metrics import error_metrics, mean_median_error


@dataclasses.dataclass(frozen=True)
class DsecEvalRig:
    """Geometry needed by the protocol (from cam_to_cam.yaml)."""

    Q: np.ndarray          # (4, 4) disparity-to-depth for the GT stereo pair
    T_rect0_0: np.ndarray  # (4, 4) rectification rotation of cam0
    K_target: np.ndarray   # (3, 3) projection into the left event camera
    baseline: float = 0.6

    @property
    def focal(self) -> float:
        return float(self.K_target[0, 0])


def load_eval_rig_yaml(cam_to_cam_path: str, K_target: np.ndarray,
                       baseline: float = 0.6) -> DsecEvalRig:
    """Build the eval rig from a DSEC cam_to_cam.yaml plus the (already
    rectified) target intrinsics of the left event camera."""
    import yaml

    with open(cam_to_cam_path) as f:
        cc = yaml.safe_load(f)
    Q = np.asarray(cc["disparity_to_depth"]["cams_03"], np.float64)
    R = np.asarray(cc["extrinsics"]["R_rect0"], np.float64)
    T = np.eye(4)
    T[:3, :3] = R
    return DsecEvalRig(Q=Q, T_rect0_0=T, K_target=np.asarray(K_target, np.float64),
                       baseline=baseline)


def disparity_to_depth_map(
    disparity: np.ndarray, rig: DsecEvalRig, shape: Optional[Tuple[int, int]] = None
) -> np.ma.MaskedArray:
    """GT disparity image -> sparse depth in the left event camera frame.

    Mirrors evaluate_mcemvs_dsec.py:110-126: reproject via Q, drop
    infinite-depth (zero-disparity) pixels, rotate out of the rectified
    frame, project through K_target, z-buffer-free scatter (last write
    wins, as the reference's fancy-index assignment does).
    """
    H, W = disparity.shape if shape is None else shape
    d = np.asarray(disparity, np.float32)
    ys, xs = np.nonzero(d > 0)
    dv = d[ys, xs]
    # reprojectImageTo3D: [X Y Z w]^T = Q @ [x y disp 1]^T, point = XYZ/w.
    ones = np.ones_like(dv, np.float64)
    hom = np.stack([xs.astype(np.float64), ys.astype(np.float64),
                    dv.astype(np.float64), ones])
    p = rig.Q @ hom
    w = p[3]
    ok = np.abs(w) > 1e-12
    pts = p[:3, ok] / w[ok]
    finite = np.isfinite(pts).all(axis=0)
    pts = pts[:, finite]

    P_homo = np.vstack([pts, np.ones((1, pts.shape[1]))])
    P_new = np.linalg.inv(rig.T_rect0_0) @ P_homo
    z = P_new[2]
    front = z > 1e-6
    px = rig.K_target @ P_new[:3, front]
    u = (px[0] / px[2]).astype(int)
    v = (px[1] / px[2]).astype(int)
    z = z[front]
    inb = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    out = np.zeros((H, W))
    out[v[inb], u[inb]] = z[inb]
    return np.ma.array(out, mask=(out < 0.05))


def load_depth_points(path: str, shape: Tuple[int, int],
                      thicken_edges: bool = False) -> np.ma.MaskedArray:
    """Read a `[col row depth]` txt (utils.cpp:31-46 format) into a masked
    depth map, as get_mcemvs_depth does (evaluate_mcemvs_dsec.py:71-81).

    `thicken_edges` reproduces the evaluator's optional 3x3-ellipse erosion
    (evaluate_mcemvs_dsec.py:64-77, off by default there too): invalid
    pixels hold 255, so the grayscale erode spreads each semi-dense point's
    depth (the local minimum) into adjacent invalid pixels."""
    H, W = shape
    out = np.full((H, W), 255.0)
    pts = np.loadtxt(path).reshape(-1, 3)
    if pts.size:
        out[pts[:, 1].astype(int), pts[:, 0].astype(int)] = pts[:, 2]
    if thicken_edges:
        out = _erode_ellipse3(out)
    return np.ma.array(out, mask=(out == 255.0))


def _erode_ellipse3(img: np.ndarray) -> np.ndarray:
    """cv2.morphologyEx(img, MORPH_ERODE, getStructuringElement(
    MORPH_ELLIPSE, (3, 3))) — the (3,3) ellipse element is the 4-connected
    cross, so erosion is the min over the plus-shaped neighborhood.  Uses
    cv2 when present (bit parity), else an equivalent numpy min-filter."""
    try:
        import cv2

        k = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (3, 3))
        return cv2.morphologyEx(img, cv2.MORPH_ERODE, k)
    except ImportError:
        p = np.pad(img, 1, mode="edge")
        return np.minimum.reduce([
            p[1:-1, 1:-1], p[:-2, 1:-1], p[2:, 1:-1],
            p[1:-1, :-2], p[1:-1, 2:]])


def match_timestamps(
    est_times: Sequence[float],
    gt_times_us: np.ndarray,
    event_start_time: float,
    max_dt: float = 0.1,
) -> List[Tuple[int, int]]:
    """(est_idx, gt_idx) pairs within `max_dt` seconds
    (evaluate_mcemvs_dsec.py:101-108).  `est_times` are seconds relative to
    `event_start_time`; `gt_times_us` absolute microseconds."""
    pairs = []
    gt_s = gt_times_us.astype(np.float64) * 1e-6
    for i, t in enumerate(est_times):
        j = int(np.argmin(np.abs(gt_s - (t + event_start_time))))
        if abs(gt_s[j] - event_start_time - t) < max_dt:
            pairs.append((i, j))
    return pairs


def evaluate_sequence(
    est_maps: Sequence[np.ma.MaskedArray],
    gt_maps: Sequence[np.ma.MaskedArray],
    rig: DsecEvalRig,
) -> Dict[str, object]:
    """Consolidated metrics over matched frame pairs
    (evaluate_mcemvs_dsec.py:129-145)."""
    est = np.ma.array([np.ma.asarray(m) for m in est_maps])
    gt = np.ma.array([np.ma.asarray(m) for m in gt_maps])
    mean_err, median_err = mean_median_error(est, gt)
    metrics = error_metrics(est, gt, b=rig.baseline, f=rig.focal)
    return {
        "frames": len(est_maps),
        "mean_err": mean_err,
        "median_err": median_err,
        "metrics": metrics,
    }
