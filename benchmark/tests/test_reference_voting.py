"""The plain reference: an analytic case, its poses, and agreement with the
program's exact scatter backend at a small size."""

import numpy as np
import torch

from benchmark.reference import emvs


CAM = emvs.Camera(fx=70.0, fy=70.0, cx=39.5, cy=29.5)


def _geo(depths):
    return emvs.Geometry(width=80, height=60, f=70.0, cx=39.5, cy=29.5,
                         depths=np.asarray(depths, np.float64), packet_size=64)


def test_plane_votes_peak_at_its_depth():
    """Events of points on a plane at 3 m, seen from a camera sliding 1 m
    sideways, vote their argmax at the 3 m plane (within one plane)."""
    depths = emvs.plane_depths("linear", 1.0, 5.0, 20)   # 1.0, 1.2, ..., 4.8
    k_true = 10                                          # 3.0 m
    geo = _geo(depths)
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-1.5, 1.5, 40), rng.uniform(-1.0, 1.0, 40),
                    np.full(40, depths[k_true])], -1)
    t = np.sort(rng.uniform(0.0, 1.0, 6400))
    cam_x = 1.0 * t - 0.5
    which = rng.integers(0, 40, t.shape[0])
    X = pts[which] - np.stack([cam_x, 0 * t, 0 * t], -1)
    u = geo.f * X[:, 0] / X[:, 2] + geo.cx
    v = geo.f * X[:, 1] / X[:, 2] + geo.cy
    ok = (u >= 0) & (u < 79) & (v >= 0) & (v < 59)
    x, y, t = np.round(u[ok]).astype(np.int32), np.round(v[ok]).astype(np.int32), t[ok]
    tp = np.linspace(-0.1, 1.1, 13)
    poses = emvs.Poses.from_arrays(tp, np.tile([1.0, 0, 0, 0], (13, 1)),
                                   np.stack([1.0 * tp - 0.5, 0 * tp, 0 * tp], -1))
    R_rv, p_rv, _ = poses.at(0.5)
    dsi = emvs.vote(geo, CAM, x, y, t, poses, R_rv[0], p_rv[0], "cpu")
    idx = dsi.argmax(0)
    u0 = np.round(geo.f * pts[:, 0] / pts[:, 2] + geo.cx).astype(int)
    v0 = np.round(geo.f * pts[:, 1] / pts[:, 2] + geo.cy).astype(int)
    seen = (u0 >= 0) & (u0 < 80) & (v0 >= 0) & (v0 < 60)
    assert seen.sum() > 20
    hits = np.abs(idx[v0[seen], u0[seen]].numpy() - k_true) <= 1
    assert hits.mean() > 0.9, hits.mean()
    # An event puts one vote into each plane where its footprint lies on the
    # sensor: at most one a plane, exactly one in the far planes here.
    per_event = dsi.double().sum((1, 2)) / x.shape[0]
    assert float(per_event.max()) <= 1.0 + 1e-6
    assert torch.allclose(per_event[-5:], torch.ones(5, dtype=torch.float64), atol=1e-6)


def test_pose_interpolation():
    tp = np.array([0.0, 1.0, 2.0])
    ang = np.deg2rad([0.0, 20.0, 40.0])
    q = np.stack([np.cos(ang / 2), 0 * ang, np.sin(ang / 2), 0 * ang], -1)
    p = np.array([[0.0, 0, 0], [1.0, 0, 0], [2.0, 1.0, 0]])
    poses = emvs.Poses.from_arrays(tp, q, p)
    R, pp, ok = poses.at(np.array([0.0, 1.0, 0.5, 2.0, -0.1]))
    assert ok.tolist() == [True, True, True, False, False]
    assert np.allclose(R[1], emvs.quat_to_rot(q[1:2])[0])
    assert np.allclose(pp[1], p[1])
    # Halfway on SE(3): half the rotation about y.
    half = emvs.quat_to_rot(np.array([[np.cos(np.deg2rad(5)), 0, np.sin(np.deg2rad(5)), 0]]))
    assert np.allclose(R[2], half[0], atol=1e-12)


def test_extraction_masked_median_and_border():
    vals = torch.arange(25, dtype=torch.float64).reshape(5, 5)
    mask = torch.ones(5, 5, dtype=torch.bool)
    mask[2, 2] = False
    med = emvs.masked_median(vals, mask, 3)
    # Centre: the 8 neighbours 6, 7, 8, 11, 13, 16, 17, 18: lower median 11.
    assert float(med[2, 2]) == 11.0
    assert float(emvs.masked_median(vals, torch.zeros(5, 5, dtype=torch.bool), 3)[2, 2]) == 0


def test_reference_matches_the_programs_exact_vote():
    """At a small size the program, on its exact vote as the cells run it,
    and the reference agree to float rounding: same windows, packets, poses,
    reference view, vote, fusion and extraction."""
    from benchmark import harness
    from benchmark.tests import _cells

    for name in ("dsec_zurich04.replay_dense", "mvsec_flying1_athc.replay"):
        out = harness.run(_cells.tiny(name), 2**31 + 99, 0.5, False, "cpu", log=lambda m: None)
        assert out.rows, name
        for row in out.rows:
            assert row["dsi_l1"] < 1e-4 and row["fused_l1"] < 1e-4, (name, row)
            assert row["maps_off"] < 0.02, (name, row)
