"""DSEC-scale golden accuracy fixture: real motion, analytic ground truth.

Port of dvs_mcemvs_tpu/utils/golden.py.  A 640x480x100 DSI workload driven
by a real 0.4 s window of the committed zurich_city_04 odometry poses
(data/DSEC/zurich_city_04_pose.npz) over a scene of vertical stripes, each
backed by a fronto-parallel plane, so the depth at every reference-view
pixel is known analytically.  The committed exact-scatter anchors
(tests/golden/*.npz) and the error budgets that gate a voting spec against
them are shared with the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..mapper import DsiShape, Events, make_mapper
from ..ops import se3, trajectory as trajmod
from ..ops.camera import PinholeCamera
from ..ops.se3 import SE3

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
POSE_NPZ = os.path.join(_REPO, "data", "DSEC", "zurich_city_04_pose.npz")
# The JAX package's fixture event streams for SMALL and BENCH16, written by
# scripts/make_golden_events.py: the anchors were voted from them, and a
# re-simulation here moves ~1 in 20,000 events across a float32 pixel
# rounding boundary.
GOLDEN_EVENTS_NPZ = os.path.join(_REPO, "tests", "golden", "golden_events.npz")

WIDTH, HEIGHT = 640, 480
FX = 555.0
BASELINE = 0.6
DIM_Z = 100
MIN_DEPTH, MAX_DEPTH = 4.0, 24.0
DEPTH_SAMPLING = "inverse"
WINDOW_OFFSET_S = 10.0
WINDOW_LEN_S = 0.4
STRIPE_DEPTHS = (5.0, 8.0, 12.0, 20.0, 6.0, 10.0, 16.0, 7.0)
SEED = 20260819


@dataclasses.dataclass(frozen=True)
class GoldenConfig:
    """Dimension/effort profile of the golden fixture."""

    width: int = WIDTH
    height: int = HEIGHT
    fx: float = FX
    dim_z: int = DIM_Z
    n_samples: int = 24
    n_per_stripe: int = 4000
    max_events: int = 262_144
    npz_name: str = "golden_dsec.npz"
    window_offset_s: float = WINDOW_OFFSET_S

    @property
    def pad_px(self) -> float:
        """Scene overscan beyond the stripe/image edge, in this profile's px."""
        return 80.0 * self.width / WIDTH


FULL = GoldenConfig()
SMALL = GoldenConfig(width=320, height=240, fx=FX / 2, dim_z=50,
                     n_samples=16, n_per_stripe=1500, max_events=65_536,
                     npz_name="golden_dsec_small.npz")
# The window whose 0.393 m of travel makes the auto group size g16, the
# group size of the headline workload, so its gate runs the literal spec.
BENCH16 = GoldenConfig(window_offset_s=10.9, npz_name="golden_dsec_g16.npz")

# Error budget gating a voting spec against the committed exact-scatter
# anchors (the JAX package's, unchanged; its module explains each number).
BUDGET = {
    "confident_quantile": 0.8,
    "frac_within_1_plane": 0.76,
    "frac_within_2_planes": 0.85,
    "median_err_planes": 1.0,
    "per_camera_mass_rel": 0.005,
    "gt_median_rel_err": 0.05,
    "golden_gt_median_planes": 0.5,
}
BUDGET_BENCH16 = dict(BUDGET, **{
    "frac_within_1_plane": 0.73,
    "frac_within_2_planes": 0.835,
})


def dsec_like_camera(cfg: GoldenConfig = FULL) -> PinholeCamera:
    return PinholeCamera(width=cfg.width, height=cfg.height, fx=cfg.fx,
                         fy=cfg.fx, cx=cfg.width / 2 - 0.5, cy=cfg.height / 2 - 0.5)


def golden_trajectories(cfg: GoldenConfig = FULL, device=None
                        ) -> Tuple[trajmod.Trajectory, trajmod.Trajectory]:
    """(left, right) camera trajectories over the window, with t=0 at the
    window start, on `device` (the CUDA device by default; device="cpu" for
    the CPU)."""
    d = np.load(POSE_NPZ)
    t, q, p = (np.asarray(d["t"], np.float64), np.asarray(d["q"], np.float64),
               np.asarray(d["p"], np.float64))
    w0 = t[0] + cfg.window_offset_s
    sel = (t >= w0 - 0.3) & (t <= w0 + WINDOW_LEN_S + 0.3)
    t, q, p = t[sel] - w0, q[sel], p[sel]
    traj0 = trajmod.from_arrays(t, q, p, device=device)
    T_1_0 = SE3(torch.tensor([1.0, 0.0, 0.0, 0.0], device=traj0.device),
                torch.tensor([-BASELINE, 0.0, 0.0], device=traj0.device))
    return traj0, trajmod.apply_right(traj0, se3.inverse(T_1_0))


@dataclasses.dataclass(frozen=True)
class GoldenScene:
    pts_w: np.ndarray        # (N, 3) world points
    T_w_rv: SE3              # reference-view pose (left cam at window mid)
    gt_depth: np.ndarray     # (H, W) analytic RV depth (stripe planes)
    stripe_depths: Tuple[float, ...]
    cfg: GoldenConfig = FULL


def make_golden_scene(cfg: GoldenConfig = FULL, seed: int = SEED) -> GoldenScene:
    """Stripe-plane scene anchored at the RV (left camera at the window
    midpoint), built on the CPU."""
    cam = dsec_like_camera(cfg)
    traj0, _ = golden_trajectories(cfg, device="cpu")
    T_w_rv, valid = trajmod.pose_at(traj0, WINDOW_LEN_S / 2.0)
    if not bool(valid):
        raise ValueError("reference-view time outside the pose window")
    rng = np.random.default_rng(seed)
    S = len(STRIPE_DEPTHS)
    stripe_w = cfg.width / S
    pad = cfg.pad_px
    pts_rv: List[np.ndarray] = []
    for s, depth in enumerate(STRIPE_DEPTHS):
        u = rng.uniform(s * stripe_w - (pad if s == 0 else 2.0),
                        (s + 1) * stripe_w + (pad if s == S - 1 else 2.0),
                        cfg.n_per_stripe)
        v = rng.uniform(-pad, cfg.height + pad, cfg.n_per_stripe)
        x = (u - cam.cx) / cam.fx * depth
        y = (v - cam.cy) / cam.fy * depth
        pts_rv.append(np.stack([x, y, np.full_like(x, depth)], axis=-1))
    pts = torch.as_tensor(np.concatenate(pts_rv, axis=0).astype(np.float32))
    pts_w = se3.transform_points(T_w_rv, pts).numpy().astype(np.float64)
    us = np.arange(cfg.width)
    stripe_of_col = np.minimum((us / stripe_w).astype(int), S - 1)
    gt = np.asarray(STRIPE_DEPTHS, np.float32)[stripe_of_col]
    gt_depth = np.broadcast_to(gt[None, :], (cfg.height, cfg.width)).copy()
    return GoldenScene(pts_w=pts_w, T_w_rv=T_w_rv, gt_depth=gt_depth,
                       stripe_depths=STRIPE_DEPTHS, cfg=cfg)


def gt_depth_at_pose(scene: GoldenScene, T_w_c: SE3,
                     min_t: float = 0.5,
                     T_w_c_right: Optional[SE3] = None) -> np.ndarray:
    """Analytic GT depth for the left camera at an ARBITRARY pose — the
    multi-frame extension of `GoldenScene.gt_depth` (which is only valid at
    the reference view itself).

    Per pixel, rays are traced against the stripe planes (z = const in the
    RV frame over the stripe's padded column extent, `make_golden_scene`);
    the depth is the nearest hit.  Pixels where a SECOND stripe also hits
    (parallax makes padded stripe extents overlap away from the RV) are
    marked 0 = invalid: the event simulation renders both surfaces without
    occlusion, so no single depth is "true" there — the DSEC evaluator
    masks GT below 0.05 m (scripts/evaluate_dsec.py).  The poses are the
    port's SE3 on any device; the trace runs on the host in float64.

    `T_w_c_right` additionally masks pixels whose surface point falls
    OUTSIDE the right camera's frustum: stereo fusion has no vote support
    there (at z=5 m the rig's 0.6 m baseline is a 67 px disparity, so the
    left image's left edge is stereo-blind), and the real-data protocol
    this stands in for never evaluates such pixels because LiDAR GT and
    event texture coexist only in the stereo-visible field.
    """
    cam = dsec_like_camera(scene.cfg)
    T_w_rv = SE3(scene.T_w_rv.q.to(T_w_c.q.device), scene.T_w_rv.t.to(T_w_c.q.device))
    T_rv_c = se3.compose(se3.inverse(T_w_rv), T_w_c)
    R = se3.quat_to_matrix(T_rv_c.q).cpu().numpy().astype(np.float64)
    o = T_rv_c.t.cpu().numpy().astype(np.float64)

    us, vs = np.meshgrid(np.arange(cam.width, dtype=np.float64),
                         np.arange(cam.height, dtype=np.float64))
    d_cam = np.stack([(us - cam.cx) / cam.fx, (vs - cam.cy) / cam.fy,
                      np.ones_like(us)], axis=-1)        # (H, W, 3)
    d_rv = d_cam @ R.T

    S = len(scene.stripe_depths)
    stripe_w = scene.cfg.width / S
    pad = scene.cfg.pad_px
    best = np.full((cam.height, cam.width), np.inf)
    hits = np.zeros((cam.height, cam.width), np.int32)
    for s, z_s in enumerate(scene.stripe_depths):
        lo = s * stripe_w - (pad if s == 0 else 2.0)
        hi = (s + 1) * stripe_w + (pad if s == S - 1 else 2.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            tt = (z_s - o[2]) / d_rv[..., 2]
            X = o[None, None, :] + tt[..., None] * d_rv
            u_rv = cam.fx * X[..., 0] / z_s + cam.cx
            v_rv = cam.fy * X[..., 1] / z_s + cam.cy
        ok = ((tt > min_t) & (u_rv >= lo) & (u_rv <= hi)
              & (v_rv >= -pad) & (v_rv <= scene.cfg.height + pad))
        hits += ok.astype(np.int32)
        best = np.where(ok & (tt < best), tt, best)
    gt = np.where((hits == 1) & np.isfinite(best), best, 0.0)

    if T_w_c_right is not None:
        # Surface point in RV coords -> right camera coords; mask pixels
        # the right camera cannot see (no stereo vote support).
        T_cr_rv = se3.compose(se3.inverse(T_w_c_right), T_w_rv)
        Rr = se3.quat_to_matrix(T_cr_rv.q).cpu().numpy().astype(np.float64)
        tr = T_cr_rv.t.cpu().numpy().astype(np.float64)
        tt = np.where(gt > 0, gt, 1.0)
        X_rv = o[None, None, :] + tt[..., None] * d_rv
        X_r = X_rv @ Rr.T + tr[None, None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            u_r = cam.fx * X_r[..., 0] / X_r[..., 2] + cam.cx
            v_r = cam.fy * X_r[..., 1] / X_r[..., 2] + cam.cy
        vis = ((X_r[..., 2] > min_t) & (u_r >= 0) & (u_r <= cam.width - 1)
               & (v_r >= 0) & (v_r <= cam.height - 1))
        gt = np.where(vis, gt, 0.0)
    return gt.astype(np.float32)


def simulate_events_se3(cam: PinholeCamera, traj: trajmod.Trajectory,
                        pts_w: np.ndarray, n_samples: int,
                        t_range: Tuple[float, float], rng: np.random.Generator,
                        max_events: Optional[int] = None) -> Events:
    """One event per visible (point, sample time) along an SE(3) trajectory
    (on the CPU, in float32 poses as the JAX package's fixture computes them)."""
    ts_samples = np.linspace(t_range[0], t_range[1], n_samples)
    pts_w32 = torch.as_tensor(pts_w.astype(np.float32))
    xs, ys, ts, ps = [], [], [], []
    for tk in ts_samples:
        T_w_c, valid = trajmod.pose_at(traj, float(np.float32(tk)))
        if not bool(valid):
            continue
        rel = se3.transform_points(se3.inverse(T_w_c), pts_w32).numpy().astype(np.float64)
        z = rel[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = cam.fx * rel[:, 0] / z + cam.cx
            v = cam.fy * rel[:, 1] / z + cam.cy
        ok = (z > 0.5) & (u >= 0) & (u < cam.width - 1) & \
             (v >= 0) & (v < cam.height - 1)
        xs.append(np.round(u[ok]).astype(np.int32))
        ys.append(np.round(v[ok]).astype(np.int32))
        n = int(ok.sum())
        ts.append(np.full(n, tk))
        ps.append((rng.uniform(size=n) > 0.5).astype(np.int8))
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    t = np.concatenate(ts)
    p = np.concatenate(ps)
    order = np.argsort(t + rng.uniform(0, 1e-5, t.shape), kind="stable")
    x, y, t, p = x[order], y[order], t[order], p[order]
    if max_events is not None and x.shape[0] > max_events:
        keep = np.sort(rng.choice(x.shape[0], max_events, replace=False))
        x, y, t, p = x[keep], y[keep], t[keep], p[keep]
    return Events(x, y, t, p)


def simulate_golden_events(cfg: GoldenConfig = FULL) -> List[Events]:
    """The (left, right) event streams of the fixture, simulated here."""
    cam = dsec_like_camera(cfg)
    traj0, traj1 = golden_trajectories(cfg, device="cpu")
    scene = make_golden_scene(cfg)
    rng = np.random.default_rng(SEED + 1)
    t_range = (0.02, WINDOW_LEN_S - 0.02)
    return [simulate_events_se3(cam, tr, scene.pts_w, cfg.n_samples, t_range,
                                rng, cfg.max_events) for tr in (traj0, traj1)]


def committed_events(cfg: GoldenConfig) -> Optional[List[Events]]:
    """The JAX package's fixture (left, right) events for `cfg` from
    GOLDEN_EVENTS_NPZ, or None when the file holds no such profile."""
    key = cfg.npz_name[:-len(".npz")]
    with np.load(GOLDEN_EVENTS_NPZ) as d:
        if f"{key}__x0" not in d.files:
            return None
        return [Events(d[f"{key}__x{c}"].astype(np.int32),
                       d[f"{key}__y{c}"].astype(np.int32),
                       d[f"{key}__t{c}"], d[f"{key}__p{c}"]) for c in range(2)]


def build_golden_fixture(cfg: GoldenConfig = FULL, device=None):
    """(mappers, events, trajs, scene, ts_rv) -- the full golden problem,
    with the trajectories on `device` (the CUDA device by default, raising
    when there is none; device="cpu" for the CPU).  The events are
    the committed ones where GOLDEN_EVENTS_NPZ has the profile, else
    simulated here."""
    cam = dsec_like_camera(cfg)
    trajs = golden_trajectories(cfg, device=device)
    scene = make_golden_scene(cfg)
    events = committed_events(cfg) or simulate_golden_events(cfg)
    shape = DsiShape(dim_z=cfg.dim_z, min_depth=MIN_DEPTH, max_depth=MAX_DEPTH)
    mappers = [make_mapper(cam, shape, DEPTH_SAMPLING),
               make_mapper(cam, shape, DEPTH_SAMPLING)]
    return mappers, events, list(trajs), scene, WINDOW_LEN_S / 2.0


def anchor_path(cfg: GoldenConfig) -> str:
    """The committed exact-scatter anchor of a profile (tests/golden/)."""
    return os.path.join(_REPO, "tests", "golden", cfg.npz_name)


# The committed anchors of the three profiles (`anchor_path` of each).
GOLDEN_NPZ = anchor_path(FULL)
GOLDEN_SMALL_NPZ = anchor_path(SMALL)
GOLDEN_BENCH16_NPZ = anchor_path(BENCH16)


def golden_meta(cfg: GoldenConfig) -> dict:
    """The `meta` record of a committed anchor."""
    return json.loads(str(np.load(anchor_path(cfg))["meta"]))


def score(dm, res, scene: GoldenScene, confident_quantile: float) -> dict:
    """A depth map `dm` and its process_1 result `res` scored against the
    committed anchor of `scene.cfg`, as the JAX package's golden gates score
    them: plane errors over the anchor's most confident pixels (above the
    `confident_quantile`), median metric error against the analytic ground
    truth over `dm`'s mask, and each camera's vote mass against the anchor's."""
    g = np.load(anchor_path(scene.cfg))
    gi = np.asarray(g["depth_indices"]).astype(int)
    conf = np.asarray(g["confidence"])
    sel = conf > np.quantile(conf, confident_quantile)
    ei = np.abs(dm.depth_indices.cpu().numpy().astype(int)[sel] - gi[sel])
    m = dm.mask.cpu().numpy() > 0
    depth = dm.depth.cpu().numpy()
    gt = scene.gt_depth
    return {"within1": float(np.mean(ei <= 1)), "within2": float(np.mean(ei <= 2)),
            "median_planes": float(np.median(ei)),
            "gt_median_rel_err": float(np.median(np.abs(depth[m] - gt[m]) / gt[m])),
            "cam_mass_rel": [abs(float(res.dsis[f"camera{c}"].double().sum())
                                 / float(g["cam_mass"][c]) - 1) for c in range(2)]}


def gate(dm, res, scene: GoldenScene, budget: dict) -> dict:
    """`score` of `dm` and `res` with `budget`'s confident quantile, and its
    verdict `pass`: within one and within two planes at least the budget's
    shares, the median plane error and the median metric error within its
    limits, and each camera's vote mass within its relative limit."""
    out = score(dm, res, scene, budget["confident_quantile"])
    out["pass"] = bool(out["within1"] >= budget["frac_within_1_plane"]
                       and out["within2"] >= budget["frac_within_2_planes"]
                       and out["median_planes"] <= budget["median_err_planes"]
                       and out["gt_median_rel_err"] < budget["gt_median_rel_err"]
                       and max(out["cam_mass_rel"]) < budget["per_camera_mass_rel"])
    return out


def production_backend_spec(events, packet_size: int,
                            cfg: GoldenConfig = FULL) -> str:
    """The spec the CLI's auto path selects for this fixture (same helper,
    same travel estimate as the JAX package)."""
    from ..ops.voting_hist import auto_backend_spec

    traj0, _ = golden_trajectories(cfg, device="cpu")
    pos = traj0.poses.t.numpy()
    travel = float(np.linalg.norm(np.diff(pos, axis=0), axis=1).sum())
    ts = traj0.ts.numpy()
    total_t = float(ts[-1] - ts[0])
    span = min(WINDOW_LEN_S, total_t)
    chunk_travel = travel * (span / total_t)
    n_pk = max(1, min(e.num for e in events) // packet_size)
    return auto_backend_spec(chunk_travel, n_pk, cfg.fx, MIN_DEPTH, MAX_DEPTH,
                             cfg.dim_z)
