"""The benchmark's one traffic generator: event streams of a calibrated rig.

A configuration file fixes the rig (`rig`: its cameras, the poses from a
file or a parametric flight; the schema is in `harness.py`'s docstring)
and the scene (`scene`); a mix file fixes the events a camera a window.
From `--seed` this builds each camera's stream over the preset's segment
[start_time_s, stop_time_s):

  - the segment is cut into strides of `out_skip` seconds; every stride
    holds exactly events_per_window / (duration / out_skip) events of each
    camera, at times inside the stride (1 % of it kept clear at each end),
    so every full_seq window holds exactly `events_per_window` events;
  - the scene is utils/golden.py's stripe scene (`make_golden_scene`,
    lines 114-144): fronto-parallel planes at `stripe_depths_m`, each a
    vertical stripe of camera 0's image (its K, no distortion) with
    `pad_px` of overscan, points uniform over it, anchored anew at camera
    0's pose in the middle of each `slot_s` of the segment;
  - an event is a point of its time's slot seen from its camera's pose at
    its time (golden.simulate_events_se3, lines 235-274): camera i sits at
    the poses composed with T_hand_eye and T_i_0^-1, as the port's CLI
    chains them (`cli._build_trajectories`); the point is projected with
    the camera's K through its forward distortion model in closed form
    (radtan as OpenCV's `projectPoints`, equidistant as `cv::fisheye`'s),
    after the transpose of its rectifying R where it has one, and rounded
    to a pixel.  Points behind 0.5 m, past the lens's monotone
    range (the radial map's derivative not positive) or off the camera's
    sensor are drawn again.

Poses for the generator are interpolated linearly (positions) and by
normalised linear interpolation (rotations); the program and the
reference interpolate the same pose arrays their own way.  Everything is
drawn on `device` from one `torch.Generator` seeded with the seed, in a few
large calls, then copied to the host as the CLI holds events: x, y int32
and t float64 seconds.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
MIN_Z = 0.5
EDGE = 0.01
# Candidates drawn for each event a stride needs, and the strides drawn at once.
OVERSAMPLE = 4
BATCH_EVENTS = 1 << 23


def flags(config: dict) -> Dict[str, str]:
    """The preset's flags as a name -> value map."""
    out = {}
    for line in config["flags"]:
        name, _, value = line.lstrip("-").partition("=")
        out[name] = value
    return out


def segment(config: dict) -> Tuple[float, float, float, float]:
    """(start, stop, duration, out_skip) of the preset."""
    f = flags(config)
    return (float(f["start_time_s"]), float(f["stop_time_s"]), float(f["duration"]),
            float(f["out_skip"]))


def pose_arrays(config: dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Camera 0's poses (t, q as w x y z, p): the raw input of both sides."""
    src = config["rig"]["poses"]
    if "file" in src:
        with open(os.path.join(BENCH, src["file"])) as f:
            d = json.load(f)
        return (np.asarray(d["t"], np.float64), np.asarray(d["q_wxyz"], np.float64),
                np.asarray(d["p"], np.float64))
    fl = src["flight"]
    t = np.arange(fl["t0"], fl["t1"] + 1e-9, 1.0 / fl["rate_hz"])
    s = t - fl["t0"]
    p = np.stack([a * np.sin(2 * np.pi * s / T) for a, T in zip(fl["amp_m"], fl["period_s"])],
                 -1)
    p[:, 2] += fl["forward_m_s"] * s
    yaw = np.deg2rad(fl["yaw_amp_deg"]) * np.sin(2 * np.pi * s / fl["yaw_period_s"])
    q = np.stack([np.cos(yaw / 2), np.zeros_like(yaw), np.sin(yaw / 2), np.zeros_like(yaw)], -1)
    return t, q, p


DISTORTIONS = ("none", "radtan", "equidistant")


def cameras(rig: dict) -> List[dict]:
    """The rig's cameras, camera 0 first, each as {width, height, K (fx,
    fy, cx, cy), distortion, D, R (3x3 or None), T_i_0 (4x4, from camera
    0's frame)}."""
    out = []
    for i, c in enumerate(rig["cameras"]):
        model = c.get("distortion", "none")
        if model not in DISTORTIONS:
            raise ValueError(f"camera {i}: distortion {model!r} is not one of {DISTORTIONS}")
        T = np.asarray(c.get("T_i_0", np.eye(4)), np.float64).reshape(4, 4)
        if i == 0 and not np.array_equal(T, np.eye(4)):
            raise ValueError("camera 0's T_i_0 is the identity")
        if len(c.get("D", [])) > {"none": 0, "radtan": 5, "equidistant": 4}[model]:
            raise ValueError(f"camera {i}: too many coefficients for {model}")
        R = c.get("R")
        out.append(dict(width=int(c["width"]), height=int(c["height"]),
                        K=[float(v) for v in c["K"]], distortion=model,
                        D=[float(d) for d in c.get("D", [])],
                        R=None if R is None else np.asarray(R, np.float64).reshape(3, 3),
                        T_i_0=T))
    if len(out) not in (2, 3):
        raise ValueError("a rig has two or three cameras, as the port's RigCalibration")
    return out


def projection(rig: dict) -> List[float]:
    """The rig's shared projection P as (fx, fy, cx, cy)."""
    return [float(v) for v in rig["P"]]


def hand_eye(rig: dict) -> Optional[np.ndarray]:
    """T_hand_eye (4x4: camera 0 in the frame of the poses), None where the
    rig gives none (the identity)."""
    T = rig.get("T_hand_eye")
    return None if T is None else np.asarray(T, np.float64).reshape(4, 4)


def rigid_inverse(T: np.ndarray) -> np.ndarray:
    """The inverse of a 4x4 rigid transform, [R^T, -R^T t]."""
    out = np.eye(4)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -(T[:3, :3].T @ T[:3, 3])
    return out


def distort(model: str, D, x: torch.Tensor, y: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Normalised coordinates through the forward model: (xd, yd, and where
    the lens is monotone).  radtan: D = k1, k2, p1, p2[, k3], OpenCV's
    `projectPoints`; equidistant: D = k1..k4, `cv::fisheye::projectPoints`."""
    if model == "radtan":
        k1, k2, p1, p2, k3 = (list(D) + [0.0] * 5)[:5]
        r2 = x * x + y * y
        radial = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        slope = 1 + r2 * (3 * k1 + r2 * (5 * k2 + r2 * 7 * k3))
        return xd, yd, slope > 0
    if model == "equidistant":
        k1, k2, k3, k4 = (list(D) + [0.0] * 4)[:4]
        r = torch.sqrt(x * x + y * y)
        th = torch.atan(r)
        t2 = th * th
        thd = th * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
        scale = torch.where(r > 0, thd / torch.clamp(r, min=1e-300), torch.ones_like(r))
        slope = 1 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
        return x * scale, y * scale, slope > 0
    raise ValueError(f"no forward model for distortion {model!r}")


def _rot(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


class _Motion:
    """Camera 0's pose at any time of the poses' span, on the device."""

    def __init__(self, t, q, p, device):
        # Each quaternion on the side of its predecessor, for the lerp.
        q = np.array(q, np.float64)
        for i in range(1, q.shape[0]):
            if np.dot(q[i], q[i - 1]) < 0:
                q[i] = -q[i]
        f64 = dict(dtype=torch.float64, device=device)
        self.t, self.q, self.p = (torch.as_tensor(a, **f64) for a in (t, q, p))

    def at(self, tq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        i1 = torch.clamp(torch.searchsorted(self.t, tq, right=True), 1, self.t.shape[0] - 1)
        i0 = i1 - 1
        a = ((tq - self.t[i0]) / (self.t[i1] - self.t[i0]))[:, None]
        p = self.p[i0] * (1 - a) + self.p[i1] * a
        return _rot(self.q[i0] * (1 - a) + self.q[i1] * a), p


def _stripe_points(scene: dict, cam0: dict, n_slots: int, gen, device) -> torch.Tensor:
    """(n_slots, S * points_per_stripe, 3) points in the anchor camera's
    frame: stripe s spans its column band of camera 0's image (the outer
    stripes `pad_px` wider, the inner ones 2 px) and the rows with `pad_px`
    of overscan, at depth stripe_depths_m[s]."""
    W, H = cam0["width"], cam0["height"]
    fx, fy, cx, cy = cam0["K"]
    depths = scene["stripe_depths_m"]
    S, n, pad = len(depths), scene["points_per_stripe"], scene["pad_px"]
    sw = W / S
    lo = torch.tensor([s * sw - (pad if s == 0 else 2.0) for s in range(S)],
                      dtype=torch.float64, device=device)
    hi = torch.tensor([(s + 1) * sw + (pad if s == S - 1 else 2.0) for s in range(S)],
                      dtype=torch.float64, device=device)
    z = torch.tensor(depths, dtype=torch.float64, device=device)
    f64 = dict(dtype=torch.float64, device=device, generator=gen)
    u = lo[None, :, None] + (hi - lo)[None, :, None] * torch.rand(n_slots, S, n, **f64)
    v = -pad + (H + 2 * pad) * torch.rand(n_slots, S, n, **f64)
    zz = z[None, :, None].expand(n_slots, S, n)
    pts = torch.stack([(u - cx) / fx * zz, (v - cy) / fy * zz, zz], -1)
    return pts.reshape(n_slots, S * n, 3)


def generate(config: dict, mix: dict, seed: int, device) -> List[Tuple[np.ndarray, ...]]:
    """Each camera's stream (x int32, y int32, t float64) on the host."""
    device = torch.device(device)
    start, stop, duration, out_skip = segment(config)
    rig = config["rig"]
    scene = config["scene"]
    per_window = int(mix["events_per_window"])
    strides_per_window = int(round(duration / out_skip))
    if per_window % strides_per_window:
        raise ValueError(f"{per_window} events a window do not split into "
                         f"{strides_per_window} strides")
    per_stride = per_window // strides_per_window
    n_strides = int(round((stop - start) / out_skip))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    motion = _Motion(*pose_arrays(config), device)
    n_slots = int(math.ceil((stop - start) / scene["slot_s"]))
    t_anchor = torch.tensor([start + (j + 0.5) * scene["slot_s"] for j in range(n_slots)],
                            dtype=torch.float64, device=device)
    t_anchor = torch.clamp(t_anchor, max=stop)
    R_a, p_a = motion.at(t_anchor)
    cams = cameras(rig)
    T_he = hand_eye(rig)
    if T_he is not None:
        p_a = p_a + R_a @ torch.as_tensor(T_he[:3, 3], dtype=torch.float64, device=device)
        R_a = R_a @ torch.as_tensor(T_he[:3, :3], dtype=torch.float64, device=device)
    local = _stripe_points(scene, cams[0], n_slots, gen, device)
    world = torch.einsum("sij,snj->sni", R_a, local) + p_a[:, None, :]
    cands = per_stride * OVERSAMPLE
    batch = max(1, BATCH_EVENTS // cands)
    f64 = dict(dtype=torch.float64, device=device, generator=gen)
    streams = []
    for cam in cams:
        # Camera i in the frame of the poses: T_hand_eye T_i_0^-1; its raw
        # sensor turned by R^T, as the reference's bearings are R times the
        # undistorted pixel.
        M = rigid_inverse(cam["T_i_0"])
        if T_he is not None:
            M = T_he @ M
        offset = torch.as_tensor(M[:3, 3], dtype=torch.float64, device=device)
        rot = M[:3, :3] if cam["R"] is None else M[:3, :3] @ cam["R"]
        turn = None if np.array_equal(rot, np.eye(3)) else \
            torch.as_tensor(rot, dtype=torch.float64, device=device)
        W, H = cam["width"], cam["height"]
        fx, fy, cx, cy = cam["K"]
        xs, ys, ts = [], [], []
        for b0 in range(0, n_strides, batch):
            nb = min(batch, n_strides - b0)
            lo = start + (b0 + torch.arange(nb, dtype=torch.float64, device=device)) * out_skip
            t = lo[:, None] + out_skip * (EDGE + (1 - 2 * EDGE) * torch.rand(nb, cands, **f64))
            slot = torch.clamp(((t - start) / scene["slot_s"]).long(), 0, n_slots - 1)
            pick = torch.randint(0, world.shape[1], (nb, cands), device=device, generator=gen)
            X = world[slot, pick]                                   # (nb, cands, 3)
            R, p = motion.at(t.reshape(-1))
            R = R.reshape(nb, cands, 3, 3)
            c = p.reshape(nb, cands, 3) + torch.einsum("bkij,j->bki", R, offset)
            rel = torch.einsum("bkji,bkj->bki", R, X - c)
            if turn is not None:
                rel = torch.einsum("ji,bkj->bki", turn, rel)
            z = rel[..., 2]
            if cam["distortion"] == "none":
                u = fx * rel[..., 0] / z + cx
                v = fy * rel[..., 1] / z + cy
                lens = True
            else:
                xd, yd, lens = distort(cam["distortion"], cam["D"], rel[..., 0] / z,
                                       rel[..., 1] / z)
                u = fx * xd + cx
                v = fy * yd + cy
            seen = (z > MIN_Z) & lens & (u >= 0) & (u < W - 1) & (v >= 0) & (v < H - 1)
            rank = torch.cumsum(seen.long(), 1)
            if int(rank[:, -1].min()) < per_stride:
                raise ValueError("the scene leaves too few points in view for a stride")
            keep = seen & (rank <= per_stride)
            t_k = t[keep].reshape(nb, per_stride)
            order = torch.argsort(t_k, dim=1)
            t_k = torch.gather(t_k, 1, order)
            u_k = torch.gather(torch.round(u[keep]).reshape(nb, per_stride), 1, order)
            v_k = torch.gather(torch.round(v[keep]).reshape(nb, per_stride), 1, order)
            ts.append(t_k.reshape(-1))
            xs.append(u_k.reshape(-1).to(torch.int32))
            ys.append(v_k.reshape(-1).to(torch.int32))
        streams.append((torch.cat(xs).cpu().numpy(), torch.cat(ys).cpu().numpy(),
                        torch.cat(ts).cpu().numpy()))
    return streams
