"""The benchmark's one traffic generator: event streams of a stereo rig.

A configuration file fixes the rig (`rig`: intrinsics, baseline, poses of
camera 0 from a file or a parametric flight) and the scene (`scene`); a mix
file fixes the events a camera a window.  From `--seed` this builds each
camera's stream over the preset's segment [start_time_s, stop_time_s):

  - the segment is cut into strides of `out_skip` seconds; every stride
    holds exactly events_per_window / (duration / out_skip) events of each
    camera, at times inside the stride (1 % of it kept clear at each end),
    so every full_seq window holds exactly `events_per_window` events;
  - the scene is utils/golden.py's stripe scene (`make_golden_scene`,
    lines 114-144): fronto-parallel planes at `stripe_depths_m`, each a
    vertical stripe of the image with `pad_px` of overscan, points uniform
    over it, anchored anew at camera 0's pose in the middle of each
    `slot_s` of the segment;
  - an event is a point of its time's slot seen from the camera's pose at
    its time, rounded to a pixel (golden.simulate_events_se3, lines
    235-274); points behind 0.5 m or off the sensor are drawn again.

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
from typing import Dict, List, Tuple

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


def _stripe_points(scene: dict, rig: dict, n_slots: int, gen, device) -> torch.Tensor:
    """(n_slots, S * points_per_stripe, 3) points in the anchor camera's
    frame: stripe s spans its column band of the image (the outer stripes
    `pad_px` wider, the inner ones 2 px) and the rows with `pad_px` of
    overscan, at depth stripe_depths_m[s]."""
    W, H, fx, fy, cx, cy = (rig[k] for k in ("width", "height", "fx", "fy", "cx", "cy"))
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
    local = _stripe_points(scene, rig, n_slots, gen, device)
    world = torch.einsum("sij,snj->sni", R_a, local) + p_a[:, None, :]
    W, H = rig["width"], rig["height"]
    cands = per_stride * OVERSAMPLE
    batch = max(1, BATCH_EVENTS // cands)
    f64 = dict(dtype=torch.float64, device=device, generator=gen)
    streams = []
    for cam in range(2):
        offset = torch.tensor([cam * rig["baseline_m"], 0.0, 0.0], dtype=torch.float64,
                              device=device)
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
            z = rel[..., 2]
            u = rig["fx"] * rel[..., 0] / z + rig["cx"]
            v = rig["fy"] * rel[..., 1] / z + rig["cy"]
            seen = (z > MIN_Z) & (u >= 0) & (u < W - 1) & (v >= 0) & (v < H - 1)
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
