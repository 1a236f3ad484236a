"""Geometry of the PyTorch port against the JAX package, on the CPU.

Same numpy inputs through both packages.  Tolerance: 1e-5 of each array's
scale.  Both sides compute in float32 with the same formulas; they differ
only in the rounding of transcendental functions and of summation order,
a few float32 ulps (~1e-7 relative), well inside 1e-5.
"""

import numpy as np
import pytest
import torch
from _torch_util import assert_rel_close, to_np

import jax.numpy as jnp
from dvs_mcemvs_tpu.ops import camera as jcam, depth_vector as jdv, se3 as jse3
from dvs_mcemvs_tpu.ops import trajectory as jtraj, voting as jvoting
from dvs_mcemvs_torch import convert
from dvs_mcemvs_torch.ops import camera as tcam, depth_vector as tdv, se3 as tse3
from dvs_mcemvs_torch.ops import trajectory as ttraj, voting as tvoting

REL = 1e-5


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _poses(rng, n):
    return _quats(rng, n), rng.normal(size=(n, 3)).astype(np.float32)


def test_se3_group_ops():
    rng = np.random.default_rng(0)
    (qa, ta), (qb, tb) = _poses(rng, 64), _poses(rng, 64)
    ja, jb = jse3.SE3(jnp.asarray(qa), jnp.asarray(ta)), jse3.SE3(jnp.asarray(qb), jnp.asarray(tb))
    ta_, tb_ = convert.se3(ja, "cpu"), convert.se3(jb, "cpu")
    j, t = jse3.compose(ja, jb), tse3.compose(ta_, tb_)
    assert_rel_close(t.q, j.q, REL, "compose q")
    assert_rel_close(t.t, j.t, REL, "compose t")
    j, t = jse3.inverse(ja), tse3.inverse(ta_)
    assert_rel_close(t.q, j.q, REL, "inverse q")
    assert_rel_close(t.t, j.t, REL, "inverse t")
    assert_rel_close(tse3.quat_to_matrix(ta_.q), jse3.quat_to_matrix(ja.q), REL, "R")
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    assert_rel_close(tse3.transform_points(ta_, torch.as_tensor(pts)),
                     jse3.transform_points(ja, jnp.asarray(pts)), REL, "points")


@pytest.mark.parametrize("spread", [1e-3, 0.5])
def test_se3_interpolate(spread):
    """Nearby poses (the small-angle branches) and far ones."""
    rng = np.random.default_rng(1)
    q0, t0 = _poses(rng, 32)
    q1 = q0 + spread * rng.normal(size=q0.shape).astype(np.float32)
    q1 /= np.linalg.norm(q1, axis=1, keepdims=True)
    t1 = t0 + spread * rng.normal(size=t0.shape).astype(np.float32)
    alpha = rng.uniform(0, 1, 32).astype(np.float32)
    J = jse3.interpolate(jse3.SE3(jnp.asarray(q0), jnp.asarray(t0)),
                         jse3.SE3(jnp.asarray(q1), jnp.asarray(t1)), jnp.asarray(alpha))
    T = tse3.interpolate(tse3.SE3(torch.as_tensor(q0), torch.as_tensor(t0)),
                         tse3.SE3(torch.as_tensor(q1), torch.as_tensor(t1)),
                         torch.as_tensor(alpha))
    assert_rel_close(T.q, J.q, REL, "q")
    assert_rel_close(T.t, J.t, REL, "t")


def test_pose_at_upper_bound_and_validity():
    rng = np.random.default_rng(2)
    n = 40
    ts = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
    q, t = _poses(rng, n)
    jt = jtraj.from_arrays(ts, q, t)
    tt = ttraj.from_arrays(ts, q, t, device="cpu")
    # Queries on knots (upper_bound semantics), between them, and outside.
    queries = np.concatenate([ts[5:10], rng.uniform(-0.1, 1.1, 64)]).astype(np.float32)
    J, jv = jtraj.pose_at(jt, jnp.asarray(queries))
    T, tv = ttraj.pose_at(tt, torch.as_tensor(queries))
    np.testing.assert_array_equal(to_np(tv), np.asarray(jv))
    assert_rel_close(T.q, J.q, REL, "q")
    assert_rel_close(T.t, J.t, REL, "t")
    right = ttraj.apply_right(tt, tse3.SE3(torch.as_tensor(q[0]), torch.as_tensor(t[0])))
    jright = jtraj.apply_right(jt, jse3.SE3(jnp.asarray(q[0]), jnp.asarray(t[0])))
    assert_rel_close(right.poses.t, jright.poses.t, REL, "apply_right")


CAMERAS = [
    jcam.PinholeCamera(width=48, height=32, fx=40.0, fy=41.0, cx=23.5, cy=15.5),
    jcam.PinholeCamera(width=48, height=32, fx=40.0, fy=41.0, cx=23.0, cy=16.0,
                       distortion_model=jcam.PLUMB_BOB, D=(-0.2, 0.05, 1e-3, -2e-3, 0.01),
                       P_fx=38.0, P_fy=38.0, P_cx=24.0, P_cy=16.0,
                       R=(0.999, -0.03, 0.0, 0.03, 0.999, 0.0, 0.0, 0.0, 1.0)),
    jcam.PinholeCamera(width=48, height=32, fx=30.0, fy=30.0, cx=24.0, cy=16.0,
                       distortion_model=jcam.FISHEYE, D=(0.1, -0.02, 0.003, -1e-4)),
]


@pytest.mark.parametrize("cam", CAMERAS, ids=["pinhole", "radtan", "fisheye"])
def test_rectification(cam):
    tc = convert.camera(cam)
    np.testing.assert_allclose(tcam.rectify_lut(tc), jcam.rectify_lut(cam), rtol=0, atol=0)
    ys, xs = np.mgrid[0:cam.height, 0:cam.width]
    x, y = xs.ravel().astype(np.int32), ys.ravel().astype(np.int32)
    ju, jv = jcam.rectify_events_device(jnp.asarray(x), jnp.asarray(y), jcam.rect_static(cam))
    tu, tv = tcam.rectify_events_device(torch.as_tensor(x), torch.as_tensor(y),
                                        tcam.rect_static(tc))
    assert_rel_close(tu, ju, REL, "u")
    assert_rel_close(tv, jv, REL, "v")
    assert tcam.virtual_camera(40, 30, 70.0, tc) == convert.camera(
        jcam.virtual_camera(40, 30, 70.0, cam))


@pytest.mark.parametrize("kind", [jdv.LINEAR, jdv.INVERSE])
def test_depth_vector(kind):
    j = jdv.DepthVector(kind, 4.0, 24.0, 100)
    t = tdv.DepthVector(kind, 4.0, 24.0, 100)
    np.testing.assert_array_equal(t.depths(), j.depths())
    idx = np.arange(100, dtype=np.int32)
    got = to_np(t.depth_at_index(torch.as_tensor(idx)))
    want = np.asarray(j.depth_at_index(jnp.asarray(idx)))
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.mark.parametrize("rectify", ["device", "lut"])
@pytest.mark.parametrize("weighted", [False, True])
def test_warp_events_to_z0(rectify, weighted):
    rng = np.random.default_rng(3)
    cam = CAMERAS[1]
    n_pose, E, P = 30, 4000, 256
    ts = np.linspace(0.0, 1.0, n_pose).astype(np.float32)
    q = _quats(rng, 1).repeat(n_pose, 0) + 0.02 * rng.normal(size=(n_pose, 4)).astype(np.float32)
    trans = np.stack([np.linspace(0, 0.4, n_pose), 0.01 * rng.normal(size=n_pose),
                      0.01 * rng.normal(size=n_pose)], -1).astype(np.float32)
    x = rng.integers(0, cam.width, E).astype(np.int32)
    y = rng.integers(0, cam.height, E).astype(np.int32)
    t = np.sort(rng.uniform(-0.3, 1.3, E)).astype(np.float32)   # edge packets invalid
    w = (rng.uniform(size=E) > 0.2).astype(np.float32) if weighted else None
    K_cam = np.asarray(cam.P, np.float32)
    vcam = jcam.virtual_camera(cam.width, cam.height, 0.0, cam)
    Kv_inv = np.linalg.inv(vcam.P).astype(np.float32)
    jt = jtraj.from_arrays(ts, q, trans)
    T_rv_w = jse3.inverse(jse3.SE3(jt.poses.q[10], jt.poses.t[10]))
    rect = jcam.rect_static(cam) if rectify == "device" else None
    lut = jcam.rectify_lut(cam)
    J = jvoting.warp_events_to_z0(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(t), jt, T_rv_w, jnp.asarray(lut),
        jnp.asarray(K_cam), jnp.asarray(Kv_inv), z0=4.0, width=cam.width,
        packet_size=P, rect_params=rect, full=weighted,
        ev_weight=None if w is None else jnp.asarray(w))
    T = tvoting.warp_events_to_z0(
        torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(t),
        convert.trajectory(jt, "cpu"), convert.se3(T_rv_w, "cpu"), torch.as_tensor(lut), torch.as_tensor(K_cam),
        torch.as_tensor(Kv_inv), z0=4.0, width=cam.width, packet_size=P,
        rect_params=None if rect is None else tcam.rect_static(convert.camera(cam)),
        full=weighted, ev_weight=None if w is None else torch.as_tensor(w))
    np.testing.assert_array_equal(to_np(T.valid), np.asarray(J.valid))
    assert not to_np(T.valid).all() and to_np(T.valid).any()
    assert_rel_close(T.xy_z0, J.xy_z0, REL, "xy_z0")
    assert_rel_close(T.centers, J.centers, REL, "centers")
    assert_rel_close(T.event_weights(), J.event_weights(), 0.0, "weights")


# The small helpers that only the JAX package's own tests reach.
# Tolerance: atol 1e-6, indices equal.


def test_se3_identity_and_to_matrix(monkeypatch):
    rng = np.random.default_rng(10)
    q, t = _poses(rng, 8)
    want = np.asarray(jse3.to_matrix(jse3.SE3(jnp.asarray(q), jnp.asarray(t))))
    got = to_np(tse3.to_matrix(tse3.SE3(torch.as_tensor(q), torch.as_tensor(t))))
    assert got.shape == (8, 4, 4)
    np.testing.assert_allclose(got, want, atol=1e-6)
    for shape in [(), (3,), (2, 5)]:
        ji, ti = jse3.identity(shape), tse3.identity(shape, device="cpu")
        np.testing.assert_array_equal(to_np(ti.q), np.asarray(ji.q))
        np.testing.assert_array_equal(to_np(ti.t), np.asarray(ji.t))
        np.testing.assert_array_equal(to_np(tse3.to_matrix(ti)),
                                      np.asarray(jse3.to_matrix(ji)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tse3.identity()


def test_trajectory_helpers():
    """t_start / t_end, apply_left and slice_time (bounds searched on the
    host, with and without padding, inside and past the ends)."""
    rng = np.random.default_rng(11)
    n = 30
    ts = np.sort(rng.uniform(0, 3, n)).astype(np.float32)
    q, t = _poses(rng, n)
    jt = jtraj.from_arrays(ts, q, t)
    tt = ttraj.from_arrays(ts, q, t, device="cpu")
    assert float(tt.t_start) == float(jt.t_start) and float(tt.t_end) == float(jt.t_end)
    T = (q[3], t[3])
    left = ttraj.apply_left(tt, tse3.SE3(torch.as_tensor(T[0]), torch.as_tensor(T[1])))
    jleft = jtraj.apply_left(jt, jse3.SE3(jnp.asarray(T[0]), jnp.asarray(T[1])))
    np.testing.assert_allclose(to_np(left.poses.q), np.asarray(jleft.poses.q), atol=1e-6)
    np.testing.assert_allclose(to_np(left.poses.t), np.asarray(jleft.poses.t), atol=1e-6)
    for lo, hi, pad in [(0.5, 1.5, 1), (0.5, 1.5, 0), (-1.0, 0.2, 2), (2.9, 9.0, 1),
                        (float(ts[4]), float(ts[9]), 1)]:
        js, ts_ = jtraj.slice_time(jt, lo, hi, pad), ttraj.slice_time(tt, lo, hi, pad)
        np.testing.assert_array_equal(to_np(ts_.ts), np.asarray(js.ts))
        np.testing.assert_array_equal(to_np(ts_.poses.q), np.asarray(js.poses.q))
        np.testing.assert_array_equal(to_np(ts_.poses.t), np.asarray(js.poses.t))


@pytest.mark.parametrize("cam", CAMERAS, ids=["pinhole", "radtan", "fisheye"])
def test_project_pixel_to_ray(cam):
    tc = convert.camera(cam)
    np.testing.assert_array_equal(tc.K, cam.K)
    rng = np.random.default_rng(12)
    u, v = rng.uniform(0, cam.width, 50), rng.uniform(0, cam.height, 50)
    got = tcam.project_pixel_to_ray(tc, u, v)
    np.testing.assert_allclose(got, jcam.project_pixel_to_ray(cam, u, v), atol=1e-6)
    assert got.shape == (50, 3)


@pytest.mark.parametrize("kind", [jdv.LINEAR, jdv.INVERSE])
def test_depth_vector_cell_helpers(kind):
    """cell_index_to_depth, depth_to_cell and depth_to_cell_index; the
    linear grid of 2 cells a metre puts depths on exact .5 cells, which
    both round up (torch.round would round 0.5 and 2.5 down to even)."""
    j = jdv.DepthVector(kind, 1.0, 5.0, 8)
    t = tdv.DepthVector(kind, 1.0, 5.0, 8)
    idx = np.array([0, 3, 7, 5, 1], np.int32)
    np.testing.assert_array_equal(to_np(t.cell_index_to_depth(torch.as_tensor(idx))),
                                  np.asarray(j.cell_index_to_depth(jnp.asarray(idx))))
    depths = np.random.default_rng(13).uniform(1.0, 5.0, 64).astype(np.float32)
    if kind == jdv.LINEAR:
        depths[:6] = [1.25, 1.75, 2.25, 3.25, 4.75, 1.0]
    np.testing.assert_allclose(to_np(t.depth_to_cell(torch.as_tensor(depths))),
                               np.asarray(j.depth_to_cell(jnp.asarray(depths))), atol=1e-6)
    got = to_np(t.depth_to_cell_index(torch.as_tensor(depths)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(j.depth_to_cell_index(jnp.asarray(depths))))
    if kind == jdv.LINEAR:
        np.testing.assert_array_equal(got[:6], [1, 2, 3, 5, 8, 0])
