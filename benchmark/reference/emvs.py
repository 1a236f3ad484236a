"""Plain reference of one full_seq chunk of MC-EMVS, in PyTorch and NumPy.

It imports nothing of the program.  From the raw inputs that the harness
hands to both sides (the event stream of each camera as host arrays, the
poses of camera 0 as times, quaternions and positions, the rig's
intrinsics and baseline, the preset's flags) it works out again:

  - the window's events, by binary search on the times;
  - packets of `packet_size` events, each at the pose of camera 0 (or of
    camera 0 shifted by the baseline) interpolated on SE(3) at the time of
    the packet's middle event;
  - the reference view: camera 0's pose at the window's end
    (`forward_looking`) or middle;
  - an exact per-event bilinear vote: each event's ray meets every depth
    plane of the reference view, and its four bilinear weights are added
    into the DSI (Z, H, W);
  - the fusion of the cameras (the harmonic mean 2ab / (a + b + 0.1)) and,
    for the temporal preset, the arithmetic mean over sub-intervals of each
    camera's DSI and of the fused DSI, and the converse order's fusion;
  - the extraction: argmax over the planes, confidence normalised to 8
    bits, OpenCV's adaptive Gaussian threshold, the masked lower median of
    the plane indices, the border, the plane depths.

Geometry runs in float64.  The DSI and everything after it run in `dtype`:
float32 as the preset states, or bfloat16 for the control.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

HM_EPS = 0.1


# ---------------------------------------------------------------------------
# Poses
# ---------------------------------------------------------------------------


def quat_to_rot(q: np.ndarray) -> np.ndarray:
    """(N, 4) quaternions (w, x, y, z), normalised here, to (N, 3, 3)."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _skew(w: np.ndarray) -> np.ndarray:
    z = np.zeros_like(w[..., 0])
    return np.stack([np.stack([z, -w[..., 2], w[..., 1]], -1),
                     np.stack([w[..., 2], z, -w[..., 0]], -1),
                     np.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def so3_log(R: np.ndarray) -> np.ndarray:
    """Rotation vectors of (N, 3, 3) rotations (angles below pi)."""
    c = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1) / 2, -1.0, 1.0)
    th = np.arccos(c)
    v = np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
                  R[:, 1, 0] - R[:, 0, 1]], -1)
    s = np.where(th < 1e-8, 0.5 + th * th / 12, th / (2 * np.sin(np.maximum(th, 1e-300))))
    return v * s[:, None]


def so3_exp(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w, axis=-1)
    K = _skew(w)
    a = np.where(th < 1e-8, 1 - th * th / 6, np.sin(th) / np.maximum(th, 1e-300))
    b = np.where(th < 1e-8, 0.5 - th * th / 24, (1 - np.cos(th)) / np.maximum(th * th, 1e-300))
    return np.eye(3) + a[:, None, None] * K + b[:, None, None] * (K @ K)


def _left_jacobian(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w, axis=-1)
    K = _skew(w)
    b = np.where(th < 1e-8, 0.5 - th * th / 24, (1 - np.cos(th)) / np.maximum(th * th, 1e-300))
    c = np.where(th < 1e-8, 1 / 6 - th * th / 120,
                 (th - np.sin(th)) / np.maximum(th ** 3, 1e-300))
    return np.eye(3) + b[:, None, None] * K + c[:, None, None] * (K @ K)


@dataclasses.dataclass(frozen=True)
class Poses:
    """Camera-to-world poses at sorted times: t (N,), R (N, 3, 3), p (N, 3)."""

    t: np.ndarray
    R: np.ndarray
    p: np.ndarray

    @staticmethod
    def from_arrays(t, q_wxyz, p) -> "Poses":
        t = np.asarray(t, np.float64)
        order = np.argsort(t, kind="stable")
        return Poses(t[order], quat_to_rot(np.asarray(q_wxyz)[order]),
                     np.asarray(p, np.float64)[order])

    def shifted(self, offset) -> "Poses":
        """The poses of a camera at `offset` (metres, in camera 0's frame)."""
        return Poses(self.t, self.R, self.p + self.R @ np.asarray(offset, np.float64))

    def at(self, tq) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(R, p, valid) at times tq: T0 exp(a log(T0^-1 T1)) on SE(3) between
        the poses around each time; times outside [t[0], t[-1]) are invalid."""
        tq = np.atleast_1d(np.asarray(tq, np.float64))
        i1 = np.searchsorted(self.t, tq, side="right")
        valid = (i1 > 0) & (i1 < len(self.t))
        i1 = np.clip(i1, 1, len(self.t) - 1)
        i0 = i1 - 1
        a = (tq - self.t[i0]) / np.maximum(self.t[i1] - self.t[i0], 1e-12)
        R0, p0 = self.R[i0], self.p[i0]
        R0T = np.swapaxes(R0, -1, -2)
        Rr = R0T @ self.R[i1]
        tr = (R0T @ (self.p[i1] - p0)[..., None])[..., 0]
        w = so3_log(Rr)
        v = np.linalg.solve(_left_jacobian(w), tr[..., None])[..., 0]
        wa, va = a[:, None] * w, a[:, None] * v
        Ra = so3_exp(wa)
        ta = (_left_jacobian(wa) @ va[..., None])[..., 0]
        return R0 @ Ra, p0 + (R0 @ ta[..., None])[..., 0], valid


# ---------------------------------------------------------------------------
# The vote
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The rig and the DSI of the preset."""

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    depths: np.ndarray        # (Z,) plane depths of the reference view
    packet_size: int = 1024


def plane_depths(kind: str, lo: float, hi: float, n: int) -> np.ndarray:
    """The preset's planes: linear d_i = lo + i (hi - lo) / n, or inverse
    1/d_i = 1/hi + i (1/lo - 1/hi) / n (n, not n - 1, as the reference)."""
    i = np.arange(n, dtype=np.float64)
    if kind == "linear":
        return lo + i * (hi - lo) / n
    if kind == "inverse":
        return 1.0 / (1.0 / hi + i * (1.0 / lo - 1.0 / hi) / n)
    raise ValueError(f"unknown depth sampling {kind!r}")


def window(t: np.ndarray, t0: float, t1: float) -> Tuple[int, int]:
    """Index range of the events with t0 <= t <= t1."""
    return (int(np.searchsorted(t, t0, side="left")),
            int(np.searchsorted(t, t1, side="right")))


def vote(geo: Geometry, x: np.ndarray, y: np.ndarray, t: np.ndarray, poses: Poses,
         R_rv: np.ndarray, p_rv: np.ndarray, device, dtype=torch.float32,
         plane_block: int = 10) -> torch.Tensor:
    """The exact bilinear vote of one camera's events into a (Z, H, W) DSI
    of `dtype` on `device`.  Packets of `packet_size` events share the pose
    at their middle event (the last event where the last packet is short);
    a packet whose time lies outside the poses does not vote."""
    E = x.shape[0]
    P = geo.packet_size
    K = -(-E // P)
    mid = np.minimum(np.arange(K) * P + P // 2, E - 1)
    R_k, p_k, ok = poses.at(t[mid])
    # Rays of the packet's events in the reference view's frame.
    R_rel = R_rv.T[None] @ R_k                              # (K, 3, 3)
    C = (R_rv.T @ (p_k - p_rv).T).T                          # (K, 3)
    f64 = dict(dtype=torch.float64, device=device)
    Rr = torch.as_tensor(R_rel, **f64)
    Cc = torch.as_tensor(C, **f64)
    pk = torch.as_tensor(np.repeat(np.arange(K), P)[:E], device=device)
    okw = torch.as_tensor(ok, device=device)[pk]
    xn = (torch.as_tensor(x, **f64) - geo.cx) / geo.fx
    yn = (torch.as_tensor(y, **f64) - geo.cy) / geo.fy
    d = Rr[pk, :, 0] * xn[:, None] + Rr[pk, :, 1] * yn[:, None] + Rr[pk, :, 2]   # (E, 3)
    c = Cc[pk]
    Z, H, W = len(geo.depths), geo.height, geo.width
    dsi = torch.zeros(Z * H * W, dtype=dtype, device=device)
    for lo in range(0, Z, plane_block):
        z = torch.as_tensor(geo.depths[lo:lo + plane_block], **f64)[:, None]   # (B, 1)
        lam = (z - c[None, :, 2]) / d[None, :, 2]
        u = geo.fx * (c[None, :, 0] + lam * d[None, :, 0]) / z + geo.cx
        v = geo.fy * (c[None, :, 1] + lam * d[None, :, 1]) / z + geo.cy
        x0, y0 = torch.floor(u), torch.floor(v)
        inb = (u >= 0) & (v >= 0) & (x0 + 1 < W) & (y0 + 1 < H) & okw[None]
        fx, fy = u - x0, v - y0
        base = (torch.arange(z.shape[0], device=device)[:, None] + lo) * (H * W) + \
            torch.where(inb, y0 * W + x0, torch.zeros_like(x0)).long()
        idx = torch.stack([base, base + 1, base + W, base + W + 1], -1)
        w = torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy], -1)
        w = torch.where(inb[..., None], w, torch.zeros_like(w))
        dsi.index_add_(0, idx.reshape(-1), w.reshape(-1).to(dtype))
    return dsi.reshape(Z, H, W)


def fuse_hm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return 2 * a * b / (a + b + HM_EPS)


# ---------------------------------------------------------------------------
# Extraction
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExtractOptions:
    threshold_kernel: int = 5
    threshold_c: float = 5.0
    median_size: int = 5
    max_confidence: float = 0.0


def _gaussian_1d(k: int) -> np.ndarray:
    """OpenCV's Gaussian taps for size k and sigma from the size."""
    sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8
    x = np.arange(k) - (k - 1) * 0.5
    g = np.exp(-x * x / (2 * sigma * sigma))
    return g / g.sum()


def _replicate_mean(img: torch.Tensor, k: int) -> torch.Tensor:
    """Separable Gaussian mean of an (H, W) image, replicated border, in the
    image's dtype."""
    g = torch.as_tensor(_gaussian_1d(k), dtype=img.dtype, device=img.device)
    r = k // 2
    x = torch.nn.functional.pad(img[None, None], (r, r, r, r), mode="replicate")[0, 0]
    H, W = img.shape
    rows = sum(g[j] * x[:, j:j + W] for j in range(k))
    return sum(g[i] * rows[i:i + H, :] for i in range(k))


def masked_median(vals: torch.Tensor, mask: torch.Tensor, m: int) -> torch.Tensor:
    """Lower median of the masked values in each m x m neighbourhood (the
    value of rank (n + 1) // 2 among the n of them), 0 where there are none."""
    H, W = vals.shape
    r = m // 2
    big = float(2 ** 30)
    v = torch.where(mask > 0, vals.to(torch.float64), torch.full_like(vals, big,
                                                                     dtype=torch.float64))
    v = torch.nn.functional.pad(v[None, None], (r, r, r, r), value=big)[0, 0]
    nb = torch.stack([v[i:i + H, j:j + W] for i in range(m) for j in range(m)], -1)
    n = (nb < big).sum(-1)
    srt = torch.sort(nb, -1).values
    rank = torch.clamp((n + 1) // 2 - 1, min=0)
    med = torch.gather(srt, -1, rank[..., None])[..., 0]
    return torch.where(n > 0, med, torch.zeros_like(med))


def extract(dsi: torch.Tensor, depths: np.ndarray, o: ExtractOptions) -> Dict[str, torch.Tensor]:
    """Depth, confidence and mask maps of a (Z, H, W) DSI, computed in the
    DSI's dtype."""
    conf = torch.amax(dsi, 0)
    idx = torch.argmax(dsi, 0)
    H, W = conf.shape
    c = conf.clone()
    if o.max_confidence > 0:
        c[0, 0] = o.max_confidence
    lo, hi = torch.min(c), torch.max(c)
    norm = (c - lo) * (255.0 / torch.clamp(hi - lo, min=1e-30))
    norm[0, 0] = 0.0
    u8 = torch.clamp(torch.round(norm), 0, 255)
    mean = torch.round(_replicate_mean(u8, o.threshold_kernel))
    mask = u8 > mean - float(np.round(np.float32(-o.threshold_c)))
    med = masked_median(idx.to(torch.float64), mask, o.median_size)
    b = max(o.threshold_kernel // 2, 1)
    ys = torch.arange(H, device=dsi.device)[:, None]
    xs = torch.arange(W, device=dsi.device)[None, :]
    keep = (xs > b) & (xs < W - b) & (ys > b) & (ys < H - b)
    mask = mask & keep
    table = torch.as_tensor(depths, dtype=torch.float64, device=dsi.device)
    depth = table[med.long().clamp(0, len(depths) - 1)]
    return {"depth": depth.to(torch.float32), "confidence": conf,
            "mask": mask.to(torch.uint8)}


# ---------------------------------------------------------------------------
# A chunk
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One chunk to work out: the window [t0, t1] and the reference view's
    time."""

    t0: float
    t1: float
    ts: float


def chunk_times(start: float, stop: float, duration: float, out_skip: float,
                forward_looking: bool) -> List[Chunk]:
    """The windows of the segment, as full_seq lays them: starts at `start`
    stepping by `out_skip` while the window ends by `stop`."""
    out, t0 = [], start
    while t0 + duration <= stop + 1e-12:
        t1 = t0 + duration
        out.append(Chunk(t0, t1, t1 if forward_looking else 0.5 * (t0 + t1)))
        t0 += out_skip
    return out


def run_chunk(geo: Geometry, streams: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
              cams: Sequence[Poses], chunk: Chunk, method: int, intervals: int,
              extract_opts: ExtractOptions, device, dtype=torch.float32) -> dict:
    """The chunk's DSIs and maps: "cams" (method 1: each camera's DSI;
    method 2: each camera's mean over `intervals` sub-intervals of equal
    event count) and "extractions" ([(dsi, maps)]: method 1, the cameras'
    fusion; method 2, the mean of each sub-interval's fusion, then the
    fusion of the two means)."""
    R_rv, p_rv, ok = cams[0].at(chunk.ts)
    if not ok[0]:
        raise ValueError(f"reference-view time {chunk.ts} outside the poses")
    R_rv, p_rv = R_rv[0], p_rv[0]
    parts = []
    for (x, y, t), poses in zip(streams, cams):
        lo, hi = window(t, chunk.t0, chunk.t1)
        if method == 1:
            parts.append([(lo, hi)])
        else:
            per = (hi - lo) // intervals
            parts.append([(lo + k * per, lo + (k + 1) * per) for k in range(intervals)])

    def dsi(c: int, k: int) -> torch.Tensor:
        (x, y, t), (lo, hi) = streams[c], parts[c][k]
        return vote(geo, x[lo:hi], y[lo:hi], t[lo:hi], cams[c], R_rv, p_rv, device, dtype)

    if method == 1:
        c0, c1 = dsi(0, 0), dsi(1, 0)
        fused = fuse_hm(c0, c1)
        return {"cams": [c0, c1],
                "extractions": [(fused, extract(fused, geo.depths, extract_opts))]}
    if method != 2:
        raise ValueError(f"process_method {method} has no reference here")
    left = right = fused = None
    for k in range(intervals):
        d0, d1 = dsi(0, k), dsi(1, k)
        f = fuse_hm(d0, d1)
        left = d0 if left is None else left + d0
        right = d1 if right is None else right + d1
        fused = f if fused is None else fused + f
    left, right, fused = left / intervals, right / intervals, fused / intervals
    camera_time = fuse_hm(left, right)
    return {"cams": [left, right],
            "extractions": [(d, extract(d, geo.depths, extract_opts))
                            for d in (fused, camera_time)]}
