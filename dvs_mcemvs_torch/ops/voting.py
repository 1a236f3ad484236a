"""Event back-projection and DSI voting.

Port of dvs_mcemvs_tpu/ops/voting.py:
  1. packets of `packet_size` consecutive events share the interpolated pose
     at the packet-midpoint timestamp;
  2. per packet, one planar homography moves rectified event pixels to the
     z0 depth plane of the reference view (`warp_events_to_z0`);
  3. a backend votes the z0 locations into every depth plane: the exact
     per-event scatter (`splat_scatter`), its sort + segment-sum form
     (`splat_sort`), or the histogram backend of `voting_hist` (spec
     strings, `resolve_backend`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels import scatter
from ..kernels.scatter import bilinear_corners
from . import se3, trajectory as trajmod
from .camera import PinholeCamera
from .se3 import SE3

DEFAULT_PACKET_SIZE = 1024


class WarpedPackets(NamedTuple):
    """Events transferred to the z0 plane, grouped in equal-size packets."""

    xy_z0: torch.Tensor    # (K, P, 2) float32 locations on plane z0
    centers: torch.Tensor  # (K, 3) float32 camera center in the RV frame
    valid: torch.Tensor    # (K,) bool: pose lookup succeeded
    weight: Optional[torch.Tensor] = None  # (K, P) per-event weight (None = 1)

    def event_weights(self) -> torch.Tensor:
        """(K*P,) flat per-event weight: packet validity times the optional
        per-event weight (0 for padding)."""
        K, P, _ = self.xy_z0.shape
        w = torch.repeat_interleave(self.valid.to(torch.float32), P)
        if self.weight is not None:
            w = w * self.weight.reshape(K * P)
        return w


def num_packets(num_events: int, packet_size: int = DEFAULT_PACKET_SIZE,
                full: bool = False) -> int:
    """Number of packets: floor((E-1)/P) as the reference loop runs while
    `current + packet_size < num_events`; with `full=True`, E // P."""
    if full:
        return num_events // packet_size
    return max(0, (num_events - 1) // packet_size)


def packet_mid_times(t: torch.Tensor, packet_size: int = DEFAULT_PACKET_SIZE,
                     full: bool = False) -> torch.Tensor:
    """Midpoint timestamp of each packet: t[k*P + P/2]."""
    K = num_packets(t.shape[0], packet_size, full)
    idx = torch.arange(K, device=t.device) * packet_size + packet_size // 2
    return t[idx]


def warp_events_to_z0(
    x: torch.Tensor,
    y: torch.Tensor,
    t: torch.Tensor,
    traj: trajmod.Trajectory,
    T_rv_w: SE3,
    lut: Optional[torch.Tensor],
    K_cam: torch.Tensor,
    Kinv_virtual: torch.Tensor,
    z0: float,
    width: int,
    packet_size: int = DEFAULT_PACKET_SIZE,
    ev_weight: Optional[torch.Tensor] = None,
    full: bool = False,
    rect_params: Optional[tuple] = None,
) -> WarpedPackets:
    """Packet poses, homographies, and event transfer to plane z0.

    x, y: (E,) integer pixels; t: (E,) float32 seconds; lut: (H*W, 2)
    rectification LUT (unused when `rect_params` selects the analytic
    rectification); K_cam: 3x3 rectified intrinsics of the camera;
    Kinv_virtual: 3x3 inverse intrinsics of the virtual RV camera.  A packet
    whose pose lookup fails is masked invalid.  The 3x3 products run in full
    fp32 (TF32 is off, see `device`).
    """
    E = x.shape[0]
    K = num_packets(E, packet_size, full)
    n = K * packet_size
    xk = x[:n].reshape(K, packet_size)
    yk = y[:n].reshape(K, packet_size)

    ts_mid = packet_mid_times(t, packet_size, full)
    T_w_ev, valid = trajmod.pose_at(traj, ts_mid)
    T_rv_ev = se3.compose(
        SE3(T_rv_w.q.expand(K, 4), T_rv_w.t.expand(K, 3)), T_w_ev)
    T_ev_rv = se3.inverse(T_rv_ev)
    R = se3.quat_to_matrix(T_ev_rv.q)              # (K, 3, 3)
    tt = T_ev_rv.t                                 # (K, 3)
    centers = -torch.einsum("kij,ki->kj", R, tt)   # -R^T t

    # H_z0^{-1} = z0 * R + t e3^T in pixel coords.
    H_inv = z0 * R
    H_inv[:, :, 2] += tt
    H_inv_px = torch.matmul(torch.matmul(K_cam, H_inv), Kinv_virtual)
    H_px = _inv3x3(H_inv_px)                       # (K, 3, 3)

    if rect_params is not None:
        from .camera import rectify_events_device

        u, v = rectify_events_device(xk, yk, rect_params)
    else:
        rect = lut[yk.long() * width + xk.long()]  # (K, P, 2)
        u, v = rect[..., 0], rect[..., 1]
    hx = H_px[:, None, 0, 0] * u + H_px[:, None, 0, 1] * v + H_px[:, None, 0, 2]
    hy = H_px[:, None, 1, 0] * u + H_px[:, None, 1, 1] * v + H_px[:, None, 1, 2]
    hz = H_px[:, None, 2, 0] * u + H_px[:, None, 2, 1] * v + H_px[:, None, 2, 2]
    xy_z0 = torch.stack([hx / hz, hy / hz], dim=-1)
    w = None if ev_weight is None else ev_weight[:n].reshape(K, packet_size)
    return WarpedPackets(xy_z0.to(torch.float32), centers, valid, w)


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    inv_det = (1.0 / det)[..., None, None]
    adj = torch.stack([
        torch.stack([A00, A01, A02], dim=-1),
        torch.stack([A10, A11, A12], dim=-1),
        torch.stack([A20, A21, A22], dim=-1),
    ], dim=-2)
    return adj * inv_det


def eq15_coefficients(centers: torch.Tensor, depths: torch.Tensor, z0: float,
                      fx: float, fy: float, cx: float, cy: float):
    """Per-(packet, plane) affine coefficients of Eq. (15); each (K, Z)."""
    C = centers
    zi = depths[None, :]
    a = z0 * (zi - C[:, 2:3])
    bx = (z0 - zi) * (C[:, 0:1] * fx + C[:, 2:3] * cx)
    by = (z0 - zi) * (C[:, 1:2] * fy + C[:, 2:3] * cy)
    d = zi * (z0 - C[:, 2:3])
    return a, bx, by, d


def splat_scatter(
    packets: WarpedPackets,
    depths: torch.Tensor,
    z0: float,
    vcam_params: Tuple[float, float, float, float],
    width: int,
    height: int,
    plane_block: int = 8,
) -> torch.Tensor:
    """Exact per-event bilinear scatter-add into every plane:
    `kernels.scatter.scatter_vote` on the Eq. 15 coefficients of every
    (packet, plane).  `plane_block` is the plain version's block of planes."""
    fx, fy, cx, cy = vcam_params
    K, P, _ = packets.xy_z0.shape
    coef = torch.stack(eq15_coefficients(packets.centers, depths, z0, fx, fy, cx, cy),
                       dim=-1)                                      # (K, Z, 4)
    return scatter.scatter_vote(packets.xy_z0.reshape(K * P, 2), packets.event_weights(),
                                coef, width=width, height=height, plane_block=plane_block)


def splat_sort(
    packets: WarpedPackets,
    depths: torch.Tensor,
    z0: float,
    vcam_params: Tuple[float, float, float, float],
    width: int,
    height: int,
    plane_block: int = 8,
) -> torch.Tensor:
    """Sort + segment-sum backend: per block of `plane_block` planes, the
    flat voxel indices of every 4-corner vote are sorted, each run of equal
    indices is summed, and one write stores the run totals.

    A run's total is the difference of two running sums, as in the JAX
    package, but the running sum is float64 here: the JAX package's float32
    one steps by 1.0 once it passes 2^23, which a plane block of the
    headline chunk (1 Mi events x 4 taps x 8 planes) reaches, and its
    voxel totals (a few votes each) then lose whole votes.  In float64 a
    total is as exact as float32 can hold it.  Every shape is fixed by the
    inputs' (no `nonzero`), so the backend can be captured in a CUDA graph:
    each run's end sum is written at its run number, a running count of the
    ends before it, and the slots that end no run write into spare slots."""
    fx, fy, cx, cy = vcam_params
    K, P, _ = packets.xy_z0.shape
    E = K * P
    xy = packets.xy_z0.reshape(E, 2)
    pw = packets.event_weights()
    Z = depths.shape[0]
    HW = height * width
    key_dtype = torch.int32 if Z * HW < 2**31 else torch.int64
    out = torch.zeros(Z * HW + 1, dtype=torch.float32, device=xy.device)
    last = torch.ones(1, dtype=torch.bool, device=xy.device)
    for z_lo in range(0, Z, plane_block):
        sl = slice(z_lo, min(z_lo + plane_block, Z))
        a, bx, by, d = (c.T.repeat_interleave(P, dim=1) for c in eq15_coefficients(
            packets.centers, depths[sl], z0, fx, fy, cx, cy))     # (ZB, E)
        X = (xy[None, :, 0] * a + bx) / d
        Y = (xy[None, :, 1] * a + by) / d
        idx4, w4 = bilinear_corners(X, Y, width, height)          # (ZB, E, 4)
        plane = (z_lo + torch.arange(a.shape[0], device=xy.device))[:, None, None] * HW
        sidx, order = torch.sort((idx4 + plane).reshape(-1).to(key_dtype))
        csum = torch.cumsum((w4 * pw[None, :, None]).reshape(-1)[order].double(), 0)
        # A run of equal voxel indices ends where the next index differs; its
        # total is the running sum there less the one at the previous end.
        # Run r's running sum at its end goes to at_end[r + 1] (at_end[0] = 0,
        # slots that end no run go to the spare at_end[n + 1]).
        end = torch.cat([sidx[1:] != sidx[:-1], last])
        n = end.shape[0]
        run = torch.cumsum(end, 0) - end.long()
        at_end = torch.zeros(n + 2, dtype=torch.float64, device=xy.device)
        at_end.index_put_((torch.where(end, run + 1, n + 1),), csum)
        slot = torch.where(end, sidx.long(), torch.full_like(sidx, Z * HW, dtype=torch.long))
        out.index_put_((slot,), (csum - at_end[run]).float())
    return out[:Z * HW].reshape(Z, height, width)


SPLAT_BACKENDS = {
    "scatter": splat_scatter,
    "sort": splat_sort,
}
# The JAX package's two named histogram backends, both on its one-hot-matmul
# engine: the plain grouped sweep and the exact-grouping 2x-supersampled one.
HIST_ALIASES = {"hist": "hist:g16", "hist_exact": "hist:g1,ss2"}


@functools.lru_cache(maxsize=None)
def resolve_backend(spec: str):
    """Resolve a backend spec string to a splat callable.

    Plain names: "scatter" (exact per-event scatter), "sort" (its sort +
    segment-sum form), "hist" and "hist_exact" (HIST_ALIASES).  "hist:"
    takes the JAX package's tokens: "g<N>" (group size), "seg<S>"
    (inverse-depth segments), "bf" (butterfly merge; flat without it),
    "ss<k>" (supersampling), "px<N>" / "py<N>" (z0-grid padding),
    "nocorr" (no sweep correction), "f32" (float32 histograms), "i8" (int8
    binning taps) and "pl" (the kernel engine's aligned grid; without it
    the spec is the JAX package's one-hot-matmul engine, which the port
    runs on the same kernels, see `voting_hist`).  Unknown names and
    tokens raise.
    """
    name, _, args = spec.partition(":")
    if not args:
        if name in HIST_ALIASES:
            return resolve_backend(HIST_ALIASES[name])
        if name not in SPLAT_BACKENDS:
            raise ValueError(f"unknown backend {name!r}")
        return SPLAT_BACKENDS[name]
    if name != "hist":
        raise ValueError(f"backend {name!r} takes no {args!r} options")
    from . import voting_hist

    kw = {}
    for tok in args.split(","):
        if tok.startswith("seg"):
            kw["segments"] = int(tok[3:])
        elif tok.startswith("ss"):
            kw["supersample"] = int(tok[2:])
        elif tok.startswith("g"):
            kw["group_size"] = int(tok[1:])
        elif tok.startswith("px"):
            kw["pad_x"] = int(tok[2:])
        elif tok.startswith("py"):
            kw["pad_y"] = int(tok[2:])
        elif tok == "nocorr":
            kw["correct"] = False
        elif tok == "f32":
            kw["dtype"] = torch.float32
        elif tok == "i8":
            kw["bin_dtype"] = torch.int8
        elif tok == "pl":
            kw["engine"] = "pallas"
        elif tok == "bf":
            kw["merge_mode"] = "butterfly"
        else:
            raise ValueError(f"unknown hist option {tok!r} in {spec!r}")
    return voting_hist.make_hist_backend(**kw)


def vote_dsi(
    packets: WarpedPackets,
    depths,
    vcam: PinholeCamera,
    backend: str = "scatter",
    plane_block: int = 8,
) -> torch.Tensor:
    """Step 3: vote all packets into a fresh (Z, H, W) DSI on the packets'
    device.  `depths` (numpy or tensor) are the plane depths; z0 is read
    from the first on the host.  `backend` is a `resolve_backend` spec."""
    z0 = float(depths[0])
    fn = resolve_backend(backend)
    return fn(
        packets,
        torch.as_tensor(depths, dtype=torch.float32, device=packets.xy_z0.device),
        z0,
        (float(vcam.fx), float(vcam.fy), float(vcam.cx), float(vcam.cy)),
        vcam.width,
        vcam.height,
        plane_block=plane_block,
    )
