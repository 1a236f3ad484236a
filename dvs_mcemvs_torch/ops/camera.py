"""Pinhole camera model, distortion, and the rectification LUT.

Port of dvs_mcemvs_tpu/ops/camera.py.  The camera, the virtual camera and
the (H*W, 2) rectification LUT are init-time host work in numpy;
`rectify_events_device` recomputes the same rectification per event on the
events' device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

PLUMB_BOB = "plumb_bob"
FISHEYE = "fisheye"  # equidistant / Kannala-Brandt 4-term
NONE = "none"


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    """Intrinsics of a (possibly distorted) pinhole camera.

    K/D describe the raw sensor; P is the shared rectified projection used
    for the DSI; R is the rectifying rotation (identity when None).
    """

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    distortion_model: str = NONE
    D: Tuple[float, ...] = ()
    P_fx: Optional[float] = None
    P_fy: Optional[float] = None
    P_cx: Optional[float] = None
    P_cy: Optional[float] = None
    R: Optional[Tuple[float, ...]] = None  # row-major 3x3 rectification rotation

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float64,
        )

    @property
    def P(self) -> np.ndarray:
        fx = self.P_fx if self.P_fx is not None else self.fx
        fy = self.P_fy if self.P_fy is not None else self.fy
        cx = self.P_cx if self.P_cx is not None else self.cx
        cy = self.P_cy if self.P_cy is not None else self.cy
        return np.array(
            [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=np.float64
        )

    @property
    def Rmat(self) -> np.ndarray:
        if self.R is None:
            return np.eye(3)
        return np.asarray(self.R, dtype=np.float64).reshape(3, 3)

    def with_projection(self, other: "PinholeCamera") -> "PinholeCamera":
        """Adopt another camera's rectified projection (shared-P convention)."""
        P = other.P
        return dataclasses.replace(
            self, P_fx=P[0, 0], P_fy=P[1, 1], P_cx=P[0, 2], P_cy=P[1, 2])


def virtual_camera(
    dim_x: int, dim_y: int, fov_deg: float, ref_cam: PinholeCamera
) -> PinholeCamera:
    """The undistorted virtual camera at the reference view: focal length
    from `fov_deg` if >= 10, else the reference camera's rectified fx;
    principal point from the reference camera's rectified P."""
    P = ref_cam.P
    if fov_deg < 10.0:
        f = float(P[0, 0])
    else:
        f = 0.5 * dim_x / np.tan(0.5 * np.deg2rad(fov_deg))
    return PinholeCamera(
        width=dim_x, height=dim_y, fx=f, fy=f,
        cx=float(P[0, 2]), cy=float(P[1, 2]), distortion_model=NONE,
    )


def _undistort_radtan(xd: np.ndarray, yd: np.ndarray, D, iters: int = 5):
    """Iterative inverse of the radial-tangential (plumb_bob) model, the same
    fixed-point scheme as cv::undistortPoints, on normalized coordinates."""
    k = np.zeros(8)
    k[: len(D)] = D
    k1, k2, p1, p2, k3 = k[0], k[1], k[2], k[3], k[4]
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (xd - dx) * icdist
        y = (yd - dy) * icdist
    return x, y


def _undistort_fisheye(xd: np.ndarray, yd: np.ndarray, D, iters: int = 10):
    """Inverse of the equidistant (Kannala-Brandt k1..k4) model, the same
    Newton scheme as cv::fisheye::undistortPoints."""
    k = np.zeros(4)
    k[: len(D)] = D[:4]
    theta_d = np.sqrt(xd * xd + yd * yd)
    theta_d_c = np.clip(theta_d, -np.pi / 2, np.pi / 2)
    theta = theta_d_c.copy()
    for _ in range(iters):
        t2 = theta * theta
        t4, t6, t8 = t2 * t2, t2 * t2 * t2, t2 * t2 * t2 * t2
        k0_ = k[0] * t2
        k1_ = k[1] * t4
        k2_ = k[2] * t6
        k3_ = k[3] * t8
        theta_fix = (theta * (1 + k0_ + k1_ + k2_ + k3_) - theta_d_c) / (
            1 + 3 * k0_ + 5 * k1_ + 7 * k2_ + 9 * k3_
        )
        theta = theta - theta_fix
    scale = np.where(theta_d > 1e-8, np.tan(theta) / np.maximum(theta_d, 1e-12), 1.0)
    return xd * scale, yd * scale


def rectify_lut(cam: PinholeCamera) -> np.ndarray:
    """Per-pixel rectified pixel coordinates, shape (H*W, 2) float32; entry
    [y*W + x] is the rectified location of raw pixel (x, y)."""
    H, W = cam.height, cam.width
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    xn = (xs - cam.cx) / cam.fx
    yn = (ys - cam.cy) / cam.fy
    if cam.distortion_model == PLUMB_BOB and any(d != 0 for d in cam.D):
        xu, yu = _undistort_radtan(xn, yn, cam.D)
    elif cam.distortion_model == FISHEYE and any(d != 0 for d in cam.D):
        xu, yu = _undistort_fisheye(xn, yn, cam.D)
    else:
        xu, yu = xn, yn
    R = cam.Rmat
    P = cam.P
    pts = np.stack([xu, yu, np.ones_like(xu)], axis=-1) @ R.T
    u = P[0, 0] * pts[..., 0] / pts[..., 2] + P[0, 2]
    v = P[1, 1] * pts[..., 1] / pts[..., 2] + P[1, 2]
    return np.stack([u, v], axis=-1).reshape(H * W, 2).astype(np.float32)


def rect_static(cam: PinholeCamera) -> Tuple:
    """The camera's rectification math as a hashable tuple, for
    `rectify_events_device`."""
    model = cam.distortion_model if any(d != 0 for d in cam.D) else NONE
    R = None if cam.R is None else tuple(float(v) for v in np.asarray(cam.R).ravel())
    P = cam.P
    return (
        model,
        float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
        tuple(float(d) for d in cam.D),
        R,
        (float(P[0, 0]), float(P[1, 1]), float(P[0, 2]), float(P[1, 2])),
    )


def rectify_events_device(x: torch.Tensor, y: torch.Tensor, rect_params: Tuple):
    """Per-event analytic rectification in float32 on the tensors' device,
    equivalent to the LUT gather `lut[y*W + x]` for integer pixels.  Returns
    (u, v) rectified pixel coordinates under the shared P."""
    model, fx, fy, cx, cy, D, R, (pfx, pfy, pcx, pcy) = rect_params
    xn = (x.to(torch.float32) - cx) / fx
    yn = (y.to(torch.float32) - cy) / fy
    if model == PLUMB_BOB:
        k = list(D) + [0.0] * (8 - len(D))
        k1, k2, p1, p2, k3 = k[0], k[1], k[2], k[3], k[4]
        xu, yu = xn, yn
        for _ in range(5):
            r2 = xu * xu + yu * yu
            icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
            dx = 2 * p1 * xu * yu + p2 * (r2 + 2 * xu * xu)
            dy = p1 * (r2 + 2 * yu * yu) + 2 * p2 * xu * yu
            xu = (xn - dx) * icdist
            yu = (yn - dy) * icdist
    elif model == FISHEYE:
        k = list(D[:4]) + [0.0] * (4 - len(D[:4]))
        theta_d = torch.sqrt(xn * xn + yn * yn)
        theta_d_c = torch.clamp(theta_d, -np.pi / 2, np.pi / 2)
        theta = theta_d_c
        for _ in range(10):
            t2 = theta * theta
            t4, t6, t8 = t2 * t2, t2 * t2 * t2, t2 * t2 * t2 * t2
            num = theta * (1 + k[0] * t2 + k[1] * t4 + k[2] * t6 + k[3] * t8)
            den = 1 + 3 * k[0] * t2 + 5 * k[1] * t4 + 7 * k[2] * t6 + 9 * k[3] * t8
            theta = theta - (num - theta_d_c) / den
        scale = torch.where(theta_d > 1e-8,
                            torch.tan(theta) / torch.clamp(theta_d, min=1e-12),
                            torch.ones_like(theta_d))
        xu, yu = xn * scale, yn * scale
    else:
        xu, yu = xn, yn
    if R is not None:
        r = R
        Xc = r[0] * xu + r[1] * yu + r[2]
        Yc = r[3] * xu + r[4] * yu + r[5]
        Zc = r[6] * xu + r[7] * yu + r[8]
    else:
        Xc, Yc, Zc = xu, yu, 1.0
    u = pfx * Xc / Zc + pcx
    v = pfy * Yc / Zc + pcy
    return u, v


def project_pixel_to_ray(cam: PinholeCamera, u, v):
    """Undistorted pixel -> unit-z bearing vector (geometry_utils.hpp:56-66),
    in numpy on the host."""
    x = (np.asarray(u) - cam.cx) / cam.fx
    y = (np.asarray(v) - cam.cy) / cam.fy
    return np.stack([x, y, np.ones_like(x)], axis=-1)
