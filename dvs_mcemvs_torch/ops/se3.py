"""SE(3) rigid transforms as (quaternion, translation) tensor pairs.

Port of dvs_mcemvs_tpu/ops/se3.py.  Conventions are the same:
  - quaternions are (w, x, y, z), unit norm, representing rotation R(q);
  - a transform T = (q, t) maps points as p' = R(q) @ p + t;
  - composition (T1 * T2) applies T2 first: R = R1 R2, t = R1 t2 + t1.
All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import require_cuda


class SE3(NamedTuple):
    """Batched rigid transform; q: (..., 4) wxyz unit quaternion, t: (..., 3)."""

    q: torch.Tensor
    t: torch.Tensor

    @property
    def batch_shape(self):
        return self.q.shape[:-1]


def identity(batch_shape=(), dtype=torch.float32, device=None) -> SE3:
    """The identity transform with batch shape `batch_shape`, on `device`
    (by default the CUDA device, raising when there is none)."""
    if device is None:
        device = require_cuda()
    batch_shape = tuple(batch_shape)
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)
    return SE3(q.expand(batch_shape + (4,)),
               torch.zeros(batch_shape + (3,), dtype=dtype, device=device))


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    """(w, -x, -y, -z), with no constant copied from the host (a CUDA graph
    cannot hold such a copy)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))


def quat_normalize_host(q) -> np.ndarray:
    """quat_normalize on the host, for poses as they are loaded
    (trajectory.from_arrays).  It differs from quat_normalize only in
    rounding: the sum of squares is a chain of fused multiply-adds rounded
    to float32 at each step, as the JAX package's `jnp.linalg.norm`
    computes it on the CPU (a float64 sum stands in for each fused step),
    so the same arrays give the same float32 quaternions in both packages
    and the pose converter writes the JAX converter's bytes
    (tests/test_torch_scripts.py::test_convert_poses_writes_the_jax_bytes
    fails with quat_normalize in its place)."""
    q = np.asarray(q, np.float32)
    q64 = q.astype(np.float64)
    acc = np.zeros(q.shape[:-1], np.float32)
    for i in range(q.shape[-1]):
        acc = (q64[..., i] * q64[..., i] + acc).astype(np.float32)
    return q / np.sqrt(acc)[..., None]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    qvec = q[..., 1:]
    uv = _cross(qvec, v)
    uuv = _cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> wxyz quaternion, branch-free
    (Shepperd): the best-conditioned of four constructions, w >= 0."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    piv = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                       1.0 - m00 - m11 + m22], dim=-1)
    piv = torch.sqrt(torch.clamp(piv, min=1e-12)) * 0.5
    case = torch.argmax(piv, dim=-1)
    p0, p1, p2, p3 = piv.unbind(-1)
    cands = torch.stack([
        torch.stack([p0, (m21 - m12) / (4 * p0), (m02 - m20) / (4 * p0),
                     (m10 - m01) / (4 * p0)], dim=-1),
        torch.stack([(m21 - m12) / (4 * p1), p1, (m01 + m10) / (4 * p1),
                     (m02 + m20) / (4 * p1)], dim=-1),
        torch.stack([(m02 - m20) / (4 * p2), (m01 + m10) / (4 * p2), p2,
                     (m12 + m21) / (4 * p2)], dim=-1),
        torch.stack([(m10 - m01) / (4 * p3), (m02 + m20) / (4 * p3),
                     (m12 + m21) / (4 * p3), p3], dim=-1),
    ], dim=-2)
    q = torch.take_along_dim(cands, case[..., None, None], dim=-2)[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


def to_matrix(a: SE3) -> torch.Tensor:
    """(..., 4, 4) homogeneous matrix."""
    top = torch.cat([quat_to_matrix(a.q), a.t[..., :, None]], dim=-1)
    bottom = a.q.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(tuple(a.batch_shape) + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def from_matrix(m: torch.Tensor) -> SE3:
    """SE3 of a (..., 4, 4) homogeneous matrix."""
    return SE3(matrix_to_quat(m[..., :3, :3]), m[..., :3, 3])


def compose(a: SE3, b: SE3) -> SE3:
    """a * b  (apply b first)."""
    return SE3(quat_normalize(quat_mul(a.q, b.q)), quat_rotate(a.q, b.t) + a.t)


def inverse(a: SE3) -> SE3:
    qi = quat_conj(a.q)
    return SE3(qi, -quat_rotate(qi, a.t))


def transform_points(a: SE3, p: torch.Tensor) -> torch.Tensor:
    return quat_rotate(a.q, p) + a.t


# ---------------------------------------------------------------------------
# exp / log maps (twist = [omega, v], rotation first)
# ---------------------------------------------------------------------------


def _sinc(x: torch.Tensor) -> torch.Tensor:
    """sin(x)/x, stable at 0."""
    x2 = x * x
    small = torch.abs(x) < 1e-4
    return torch.where(small, 1.0 - x2 / 6.0,
                       torch.sin(x) / torch.where(small, torch.ones_like(x), x))


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> quaternion."""
    theta = torch.sqrt(torch.sum(omega * omega, dim=-1, keepdim=True))
    half = 0.5 * theta
    w = torch.cos(half)
    xyz = omega * 0.5 * _sinc(half[..., 0])[..., None]
    return torch.cat([w, xyz], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> axis-angle (..., 3); takes the short path."""
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    vnorm = torch.sqrt(torch.sum(q[..., 1:] * q[..., 1:], dim=-1))
    theta = 2.0 * torch.atan2(vnorm, w)
    tiny = vnorm < 1e-9
    scale = torch.where(tiny, torch.full_like(theta, 2.0),
                        theta / torch.where(tiny, torch.ones_like(vnorm), vnorm))
    return q[..., 1:] * scale[..., None]


def _skew(w: torch.Tensor) -> torch.Tensor:
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    m = torch.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], dim=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def _left_jacobian(omega: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian J(omega) such that exp twist trans = J @ v."""
    theta = torch.sqrt(torch.sum(omega * omega, dim=-1))
    W = _skew(omega)
    W2 = torch.matmul(W, W)
    t2 = theta * theta
    small = theta < 1e-4
    safe = torch.where(small, torch.ones_like(theta), theta)
    A = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / (safe * safe))
    B = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (safe - torch.sin(safe)) / (safe ** 3))
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * W2


def _left_jacobian_inv(omega: torch.Tensor) -> torch.Tensor:
    theta = torch.sqrt(torch.sum(omega * omega, dim=-1))
    W = _skew(omega)
    W2 = torch.matmul(W, W)
    t2 = theta * theta
    small = theta < 1e-4
    safe = torch.where(small, torch.ones_like(theta), theta)
    # 1/t^2 - (1+cos t)/(2 t sin t)
    cot_term = torch.where(
        small,
        1.0 / 12.0 + t2 / 720.0,
        (1.0 / (safe * safe)) - (1.0 + torch.cos(safe)) / (2.0 * safe * torch.sin(safe)),
    )
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(W.shape)
    return eye - 0.5 * W + cot_term[..., None, None] * W2


def se3_exp(twist: torch.Tensor) -> SE3:
    """Twist (..., 6) = [omega, v] -> SE3.  t = J_l(omega) @ v."""
    omega, v = twist[..., :3], twist[..., 3:]
    q = so3_exp(omega)
    t = torch.matmul(_left_jacobian(omega), v[..., :, None])[..., 0]
    return SE3(q, t)


def se3_log(a: SE3) -> torch.Tensor:
    omega = so3_log(a.q)
    v = torch.matmul(_left_jacobian_inv(omega), a.t[..., :, None])[..., 0]
    return torch.cat([omega, v], dim=-1)


def interpolate(T0: SE3, T1: SE3, alpha: torch.Tensor) -> SE3:
    """Linear interpolation on SE(3): T0 * exp(alpha * log(T0^-1 * T1))."""
    rel = compose(inverse(T0), T1)
    tw = se3_log(rel)
    return compose(T0, se3_exp(alpha[..., None] * tw))
