"""The PyTorch port's temporal pipelines (process_2/5), the full_seq
scheduler, and the host modules around them, on the CPU against the JAX
package on the same inputs (Pallas in interpret mode where a `pl` spec
runs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_util import to_np
from test_torch_pipeline import _graft_fixture

from dvs_mcemvs_tpu import mapper as jmapper, pipeline as jpipe
from dvs_mcemvs_tpu.eval import dsec as jdsec, metrics as jmetrics
from dvs_mcemvs_tpu.ops import extract as jex, grid as jgrid, pointcloud as jpc
from dvs_mcemvs_tpu.ops import se3 as jse3, trajectory as jtraj
from dvs_mcemvs_tpu.utils import golden as jgolden
from dvs_mcemvs_torch import convert, mapper as tmapper, pipeline as tpipe
from dvs_mcemvs_torch.eval import dsec as tdsec, metrics as tmetrics
from dvs_mcemvs_torch.ops import extract as tex, grid as tgrid, pointcloud as tpc
from dvs_mcemvs_torch.ops import se3 as tse3, trajectory as ttraj
from dvs_mcemvs_torch.utils import golden as tgolden

@pytest.fixture(scope="module")
def graft():
    mappers, events, trajs, T_rv_w, packet_size = _graft_fixture()
    port = ([convert.mapper(m) for m in mappers], [convert.events(e) for e in events],
            [convert.trajectory(t, "cpu") for t in trajs])
    return (mappers, events, trajs), port, packet_size


@pytest.mark.parametrize("n", [1, 3, 4, 7])
def test_split_subintervals_match_jax(graft, n):
    (_, jev, _), (_, tev, _), _ = graft
    for shift in range(n):
        for a, b in zip(jpipe.split_subintervals_shifted(jev[1], n, shift),
                        tpipe.split_subintervals_shifted(tev[1], n, shift)):
            for f in ("x", "y", "t", "p"):
                np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    for a, b in zip(jpipe.split_subintervals(jev[0], n), tpipe.split_subintervals(tev[0], n)):
        assert a.num == b.num
        np.testing.assert_array_equal(b.t, a.t)


@pytest.mark.parametrize("method", ["process_2", "process_5"])
@pytest.mark.parametrize("temporal", [2, 4])
@pytest.mark.parametrize("spec", ["scatter", "hist:g2,seg4,bf,pl"])
def test_temporal_fusion_matches_jax(graft, method, temporal, spec):
    """Every DSI of TemporalResult against the JAX package's.  scatter: the
    same f32 arithmetic, relative L1 < 1e-4.  The kernel spec: relative L1
    < 1e-2 and per-camera temporal mass within 0.5 %, the voting tolerances
    of test_torch_pipeline; HM (temporal 2) on the voxels that drew votes,
    where 1/(0.01 + g) is not the empty voxel's 100."""
    (jm, jev, jtr), (tm, tev, ttr), packet_size = graft
    kw = dict(stereo_fusion=2, temporal_fusion=temporal, num_intervals=3)
    jres = getattr(jpipe, method)(jm, jev, jtr, 0.5, vopts=jpipe.VotingOptions(
        packet_size=packet_size, backend=spec), **kw)
    tres = getattr(tpipe, method)(tm, tev, ttr, 0.5, vopts=tpipe.VotingOptions(
        packet_size=packet_size, backend=spec), **kw)
    assert isinstance(tres, tpipe.TemporalResult)
    assert set(tres.dsis) == set(jres.dsis) == {"left_temporal", "right_temporal",
                                                "camera_time"}
    tol = 1e-4 if spec == "scatter" else 1e-2
    for name, want in [("fused", jres.fused_dsi), *jres.dsis.items()]:
        got = tres.fused_dsi if name == "fused" else tres.dsis[name]
        want = np.asarray(want, np.float64)
        got = to_np(got).astype(np.float64)
        assert got.shape == want.shape and np.isfinite(got).all()
        voted = want > (1.5 * 3 / (3 * 100.0) if temporal == 2 else 0.0)
        assert voted.sum() > 100, name
        err = np.abs(got - want)[voted].sum() / np.abs(want)[voted].sum()
        assert err < tol, f"{name}: relative L1 {err:.3g}"
    if spec != "scatter":
        for name in ("left_temporal", "right_temporal"):
            jmass = float(np.asarray(jres.dsis[name], np.float64).sum())
            assert abs(float(tres.dsis[name].double().sum()) / jmass - 1) < 0.005, name


def test_temporal_skips_small_subintervals(graft):
    """A sub-interval of at most one packet votes nothing and the fusion
    normalises by the sub-intervals that voted, as the JAX package does."""
    (jm, jev, jtr), (tm, tev, ttr), packet_size = graft
    n = jev[0].num // packet_size + 1   # every sub-interval under one packet
    with pytest.raises(ValueError, match="no sub-interval"):
        tpipe.process_2(tm, tev, ttr, 0.5, stereo_fusion=2, temporal_fusion=4,
                        num_intervals=n, vopts=tpipe.VotingOptions(packet_size=packet_size))
    with pytest.raises(ValueError, match="stereo"):
        tpipe.process_2(tm[:1], tev[:1], ttr[:1], 0.5, stereo_fusion=2, temporal_fusion=4,
                        num_intervals=2)


def test_temporal_subinterval_hook(graft):
    (_, _, _), (tm, tev, ttr), packet_size = graft
    seen = []
    tpipe.process_5(tm, tev, ttr, 0.5, stereo_fusion=2, temporal_fusion=4, num_intervals=2,
                    vopts=tpipe.VotingOptions(packet_size=packet_size),
                    on_subinterval=lambda k, d: seen.append((k, sorted(d))))
    assert seen == [(k, ["camera0", "camera1", "fused"]) for k in range(2)]


@pytest.mark.parametrize("opts", [
    dict(start_time=0.0, stop_time=1.0, duration=0.5, out_skip=0.4),
    dict(start_time=0.1, stop_time=0.9, duration=0.2, out_skip=0.05, forward_looking=True),
    dict(start_time=0.0, stop_time=0.4, duration=0.2, out_skip=0.04),
    dict(start_time=0.3, stop_time=0.35, duration=0.2, out_skip=0.1),
])
def test_full_seq_windows_and_chunks_match_jax(graft, opts):
    """The windows, and the chunks run_full_seq yields under a skip
    predicate, exactly as the JAX package's (chunks too small to vote are
    skipped by both)."""
    (jm, jev, jtr), (tm, tev, ttr), packet_size = graft
    jw = list(jpipe.full_seq_windows(jpipe.FullSeqOptions(**opts)))
    tw = list(tpipe.full_seq_windows(tpipe.FullSeqOptions(**opts)))
    assert tw == jw

    def skip(k):
        return k % 3 == 1

    def jproc(mps, evs, trs, ts):
        return jpipe.process_1(mps, evs, trs, ts, stereo_fusion=2,
                               vopts=jpipe.VotingOptions(packet_size=packet_size))

    def tproc(mps, evs, trs, ts):
        return tpipe.process_1(mps, evs, trs, ts, stereo_fusion=2,
                               vopts=tpipe.VotingOptions(packet_size=packet_size))

    jchunks = [(k, ts, {n: float(np.asarray(d).sum()) for n, d in r.dsis.items()})
               for k, ts, r in jpipe.run_full_seq(jm, jev, jtr, jpipe.FullSeqOptions(**opts),
                                                  jproc, skip=skip)]
    tchunks = [(k, ts, {n: float(d.double().sum()) for n, d in r.dsis.items()})
               for k, ts, r in tpipe.run_full_seq(tm, tev, ttr, tpipe.FullSeqOptions(**opts),
                                                  tproc, skip=skip)]
    assert [c[:2] for c in tchunks] == [c[:2] for c in jchunks]
    for (_, _, jm_), (_, _, tm_) in zip(jchunks, tchunks):
        for name in jm_:
            assert abs(tm_[name] / jm_[name] - 1) < 1e-4


def test_full_seq_stores_match_jax_stores(graft, tmp_path):
    """Native-store windows and the store scheduler's chunks, the port's
    store against the JAX package's store over the same files (the store
    quantises time to f32, so it is held to the store, not to RAM)."""
    from dvs_mcemvs_tpu.io import evstore as jstore
    from dvs_mcemvs_torch.io import evstore as tstore

    (jm, jev, jtr), (tm, tev, ttr), packet_size = graft
    jpaths = [str(tmp_path / f"j{i}.evs") for i in range(2)]
    tpaths = [str(tmp_path / f"t{i}.evs") for i in range(2)]
    for i in range(2):
        jstore.write_store(jpaths[i], jev[i])
        tstore.write_store(tpaths[i], tev[i])
        assert open(jpaths[i], "rb").read() == open(tpaths[i], "rb").read()
    js = [jstore.EventStore(p) for p in jpaths]
    ts_ = [tstore.EventStore(p) for p in tpaths]
    for t0, t1 in [(0.0, 0.5), (0.1234, 0.61), (0.9, 2.0), (0.5, 0.5)]:
        for a, b in zip(js, ts_):
            assert b.window_indices(t0, t1) == a.window_indices(t0, t1)
            wa, wb = a.window(t0, t1), b.window(t0, t1)
            for f in ("x", "y", "t", "p"):
                np.testing.assert_array_equal(getattr(wb, f), getattr(wa, f))
    opts = dict(start_time=0.0, stop_time=1.0, duration=0.3, out_skip=0.2)
    jk = [(k, ts) for k, ts, _ in jpipe.run_full_seq_stores(
        jm, js, jtr, jpipe.FullSeqOptions(**opts),
        lambda mps, evs, trs, ts: jpipe.process_1(
            mps, evs, trs, ts, 2, vopts=jpipe.VotingOptions(packet_size=packet_size)),
        skip=lambda k: k == 0)]
    tk = [(k, ts) for k, ts, _ in tpipe.run_full_seq_stores(
        tm, ts_, ttr, tpipe.FullSeqOptions(**opts),
        lambda mps, evs, trs, ts: tpipe.process_1(
            mps, evs, trs, ts, 2, vopts=tpipe.VotingOptions(packet_size=packet_size)),
        skip=lambda k: k == 0)]
    assert tk == jk and len(tk) >= 2
    for s in js + ts_:
        s.close()


def test_voting_sync_option(graft, monkeypatch):
    """`VotingOptions.sync` waits for the DSIs' device after the voting (and
    after the temporal fusion); without it nothing waits."""
    (_, _, _), (tm, tev, ttr), packet_size = graft
    waited = []
    monkeypatch.setattr(tpipe, "_synchronize", lambda t: waited.append(t.device.type))
    for sync in (False, True):
        res = tpipe.process_1(tm, tev, ttr, 0.5, 2, vopts=tpipe.VotingOptions(
            packet_size=packet_size, sync=sync))
        assert res.extracted is None and res.mev_per_s > 0
        assert waited == ["cpu"] * sync
    waited.clear()
    tpipe.process_2(tm, tev, ttr, 0.5, stereo_fusion=2, temporal_fusion=4, num_intervals=2,
                    vopts=tpipe.VotingOptions(packet_size=packet_size, sync=True))
    assert waited == ["cpu"] * 3


@pytest.mark.parametrize("op", ["fuse_add", "add_inverse"])
def test_grid_ops_match_jax(op):
    """The in-place accumulators against the JAX package's, bit for bit,
    over three sub-intervals from a zero start and from the first term."""
    rng = np.random.default_rng(3)
    subs = [(rng.gamma(0.5, 2.0, (4, 6, 8)) * (rng.uniform(size=(4, 6, 8)) > 0.3))
            .astype(np.float32) for _ in range(3)]
    want = jnp.zeros((4, 6, 8), jnp.float32)
    for g in subs:
        want = getattr(jgrid, op)(want, jnp.asarray(g))
    start = tgrid.inverse if op == "add_inverse" else torch.clone
    acc = start(torch.as_tensor(subs[0]))
    for g in subs[1:]:
        assert getattr(tgrid, op + "_")(acc, torch.as_tensor(g)) is acc
    np.testing.assert_array_equal(to_np(acc), np.asarray(want))


def test_temporal_finalizers_match_jax():
    """Within one f32 rounding: XLA may divide by multiplying with the
    reciprocal."""
    acc = np.random.default_rng(4).uniform(0.5, 300.0, (3, 4, 5)).astype(np.float32)
    for op in ("hm_from_sum_of_inv", "am_from_sum"):
        want = np.asarray(getattr(jgrid, op)(jnp.asarray(acc), 3))
        np.testing.assert_allclose(to_np(getattr(tgrid, op)(torch.as_tensor(acc), 3)), want,
                                   rtol=2.5e-7, atol=0)


@pytest.fixture(scope="module")
def depth_result(graft):
    """One fused chunk's depth map from both packages."""
    (jm, jev, jtr), (tm, tev, ttr), packet_size = graft
    jres = jpipe.process_1(jm, jev, jtr, 0.5, 2,
                           vopts=jpipe.VotingOptions(packet_size=packet_size))
    tres = tpipe.process_1(tm, tev, ttr, 0.5, 2,
                           vopts=tpipe.VotingOptions(packet_size=packet_size))
    jdm = jmapper.get_depth_map(jm[0], jres.fused_dsi, jex.DepthMapOptions())
    tdm = tmapper.get_depth_map(tm[0], tres.fused_dsi, tex.DepthMapOptions())
    return jm[0], tm[0], jdm, tdm


def test_densify_and_conf_stats_match_jax(depth_result):
    jm0, tm0, jdm, tdm = depth_result
    np.testing.assert_array_equal(to_np(tdm.depth_indices), np.asarray(jdm.depth_indices))
    np.testing.assert_array_equal(tex.densify_host(tdm, tm0.depth_vec),
                                  jex.densify_host(jdm, jm0.depth_vec))
    jmin, jmax = jex.confidence_range_stats(jdm.confidence)
    tmin, tmax = tex.confidence_range_stats(tdm.confidence)
    assert float(tmin) == pytest.approx(float(jmin), rel=1e-6)
    assert float(tmax) == pytest.approx(float(jmax), rel=1e-6)


def test_densify_without_opencv(depth_result, monkeypatch, caplog):
    """No cv2: the indices' depths, no inpainting, and a logged warning."""
    import builtins

    _, tm0, _, tdm = depth_result
    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    dense = tex.densify_host(tdm, tm0.depth_vec)
    want = tm0.depth_vec.depths()[np.clip(to_np(tdm.depth_indices), 0, tm0.depth_vec.n - 1)]
    np.testing.assert_array_equal(dense, want)
    assert "not inpainted" in caplog.text


@pytest.mark.parametrize("backend", ["kdtree", "voxel"])
def test_pointcloud_matches_jax(depth_result, backend):
    jm0, tm0, jdm, tdm = depth_result
    opts = dict(radius_search=0.3, min_num_neighbors=3)
    want = jmapper.get_pointcloud(jm0, np.asarray(jdm.depth), np.asarray(jdm.mask),
                                  jmapper.PointCloudOptions(**opts), backend=backend)
    if backend == "voxel":
        pc = tpc.depth_map_to_pointcloud(tdm.depth, tdm.mask, tm0.vcam)
        got = tpc.radius_outlier_removal(pc, 0.3, 3, backend="voxel", device="cpu")
    else:
        got = tmapper.get_pointcloud(tm0, tdm.depth, tdm.mask,
                                     tmapper.PointCloudOptions(**opts))
    assert want.xyz.shape[0] > 50
    np.testing.assert_array_equal(got.xyz, want.xyz)
    np.testing.assert_array_equal(got.intensity, want.intensity)


def test_pcd_text_matches_jax(depth_result, tmp_path):
    jm0, tm0, jdm, tdm = depth_result
    opts = (0.3, 3)
    want = jmapper.get_pointcloud(jm0, np.asarray(jdm.depth), np.asarray(jdm.mask),
                                  jmapper.PointCloudOptions(*opts))
    got = tmapper.get_pointcloud(tm0, tdm.depth, tdm.mask, tmapper.PointCloudOptions(*opts))
    jpc.save_pcd(str(tmp_path / "j.pcd"), want)
    tpc.save_pcd(str(tmp_path / "t.pcd"), got)
    assert (tmp_path / "t.pcd").read_text() == (tmp_path / "j.pcd").read_text()


def test_voxel_ror_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pc = tpc.PointCloud(np.zeros((3, 3), np.float32), np.ones(3, np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        tpc.radius_outlier_removal(pc, 0.1, 1, backend="voxel")


def test_matrix_to_quat_and_from_matrices_match_jax():
    rng = np.random.default_rng(8)
    q = rng.normal(size=(64, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    mats = np.tile(np.eye(4), (64, 1, 1))
    mats[:, :3, :3] = np.asarray(jse3.quat_to_matrix(jnp.asarray(q, jnp.float32)))
    mats[:, :3, 3] = rng.normal(size=(64, 3))
    want = np.asarray(jse3.matrix_to_quat(jnp.asarray(mats[:, :3, :3], jnp.float32)))
    got = to_np(tse3.matrix_to_quat(torch.as_tensor(mats[:, :3, :3], dtype=torch.float32)))
    np.testing.assert_allclose(got, want, atol=2e-6)
    ts = np.linspace(0, 1, 64)
    jt = jtraj.from_matrices(ts, mats)
    tt = ttraj.from_matrices(ts, mats, device="cpu")
    np.testing.assert_allclose(to_np(tt.poses.q), np.asarray(jt.poses.q), atol=2e-6)
    np.testing.assert_allclose(to_np(tt.poses.t), np.asarray(jt.poses.t), atol=0)


def test_gt_depth_at_pose_matches_jax():
    """The multi-frame golden's analytic ground truth at poses away from the
    reference view, on the SMALL profile."""
    jscene = jgolden.make_golden_scene(cfg=jgolden.SMALL)
    tscene = tgolden.make_golden_scene(tgolden.SMALL)
    jl, jr = jgolden.golden_trajectories(jgolden.SMALL)
    tl, tr = tgolden.golden_trajectories(tgolden.SMALL, device="cpu")
    for t in (0.1, 0.27):
        jp, _ = jtraj.pose_at(jl, np.float32(t))
        jpr, _ = jtraj.pose_at(jr, np.float32(t))
        tp, _ = ttraj.pose_at(tl, t)
        tpr, _ = ttraj.pose_at(tr, t)
        want = jgolden.gt_depth_at_pose(jscene, jp, T_w_c_right=jpr)
        got = tgolden.gt_depth_at_pose(tscene, tp, T_w_c_right=tpr)
        assert (want > 0).mean() > 0.3
        agree = np.isclose(got, want, rtol=1e-5, atol=0)
        assert agree.mean() > 0.999


def test_eval_metrics_match_jax():
    rng = np.random.default_rng(9)
    gt = [np.ma.array(g, mask=g < 0.05) for g in
          rng.uniform(0, 20, (3, 24, 32)) * (rng.uniform(size=(3, 24, 32)) > 0.2)]
    est = [np.ma.array(e, mask=rng.uniform(size=e.shape) > 0.5) for e in
           rng.uniform(1, 20, (3, 24, 32))]
    K = np.array([[555.0, 0, 16], [0, 555.0, 12], [0, 0, 1]])
    jrig = jdsec.DsecEvalRig(Q=np.eye(4), T_rect0_0=np.eye(4), K_target=K, baseline=0.6)
    trig = tdsec.DsecEvalRig(Q=np.eye(4), T_rect0_0=np.eye(4), K_target=K, baseline=0.6)
    want = jdsec.evaluate_sequence(est, gt, jrig)
    got = tdsec.evaluate_sequence(est, gt, trig)
    assert got["frames"] == want["frames"] == 3
    assert got["mean_err"] == want["mean_err"] and got["median_err"] == want["median_err"]
    assert got["metrics"].as_dict() == want["metrics"].as_dict()
    pj = jmetrics.precision_completeness(est[0], gt[0])
    pt = tmetrics.precision_completeness(est[0], gt[0])
    for k in pj:
        np.testing.assert_array_equal(pt[k], pj[k])
