"""The PyTorch port's process_1 slice end to end, on the CPU: against the
committed golden anchor, and against the JAX package on the same inputs.
"""

import importlib.util
import os

import numpy as np
import pytest
from _torch_util import to_np
from test_golden_fast import SMALL_BUDGET

from dvs_mcemvs_tpu import mapper as jmapper, pipeline as jpipe
from dvs_mcemvs_tpu.ops import extract as jex
from dvs_mcemvs_tpu.utils import golden as jgolden
from dvs_mcemvs_torch import convert, mapper as tmapper, pipeline as tpipe
from dvs_mcemvs_torch.ops import extract as tex
from dvs_mcemvs_torch.utils import golden as tgolden

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _graft_fixture():
    spec = importlib.util.spec_from_file_location(
        "_graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._fixture()


def test_small_golden_chip_gate():
    """The port's process_1 + get_depth_map on golden.SMALL with the kernel
    spec clears the JAX chip tier's budget against the exact-scatter anchor."""
    mappers, events, trajs, scene, ts_rv = tgolden.build_golden_fixture(tgolden.SMALL, device="cpu")
    spec = tgolden.production_backend_spec(events, 1024, cfg=tgolden.SMALL)
    assert spec == "hist:g4,seg8,bf,pl"
    vopts = tpipe.VotingOptions(packet_size=1024, backend=spec, pad_policy="bucket")
    res = tpipe.process_1(mappers, events, trajs, ts_rv, stereo_fusion=2, vopts=vopts)
    dm = tmapper.get_depth_map(mappers[0], res.fused_dsi, tex.DepthMapOptions())

    got = tgolden.score(dm, res, scene, SMALL_BUDGET["confident_quantile"])
    b = SMALL_BUDGET["chip"]
    assert got["within1"] >= b["within1"], got
    assert got["within2"] >= b["within2"], got
    assert got["median_planes"] <= b["median"], got
    assert max(got["cam_mass_rel"]) < SMALL_BUDGET["per_camera_mass_rel"], got
    assert got["gt_median_rel_err"] < b["gt_median_rel_err"], got


@pytest.mark.parametrize("name", ["SMALL", "BENCH16"])
def test_fixture_events_match_the_jax_fixture(name):
    """The port's fixture votes exactly the events the anchors were made from."""
    _, jev, *_ = jgolden.build_golden_fixture(cfg=getattr(jgolden, name))
    cfg = getattr(tgolden, name)
    _, tev, _, scene, _ = tgolden.build_golden_fixture(cfg, device="cpu")
    assert [e.num for e in tev] == tgolden.golden_meta(cfg)["events"]
    for a, b in zip(jev, tev):
        for f in ("x", "y", "t"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    g = np.load(tgolden.anchor_path(cfg))
    np.testing.assert_array_equal(scene.gt_depth, g["gt_depth"])


def test_port_simulator_tracks_the_jax_fixture():
    """Re-simulating SMALL here agrees with the JAX package's fixture but for events
    whose float32 projection lies on a pixel rounding boundary -- why the
    fixture reads the committed events instead."""
    _, jev, *_ = jgolden.build_golden_fixture(cfg=jgolden.SMALL)
    for a, b in zip(jev, tgolden.simulate_golden_events(tgolden.SMALL)):
        assert a.num == b.num
        np.testing.assert_array_equal(b.t, a.t)
        same = (a.x == b.x) & (a.y == b.y)
        assert same.mean() > 0.999


@pytest.fixture(scope="module")
def graft():
    return _graft_fixture()


def test_process_1_slice_matches_jax(graft):
    """Warp, histogram voting on the kernels' plain versions, HM fusion and
    extraction against the JAX package's process_1 (Pallas in interpret
    mode) on the same rig.  Fused DSI: relative L1 < 1e-2 and per-camera mass
    within 0.5 %, the voting tolerances of test_torch_voting_hist.  Depth
    indices: within one plane on 99 % of the pixels both masks keep (a
    bf16-level vote change can flip a near-tie argmax by one plane)."""
    mappers, events, trajs, _, packet_size = graft
    spec = "hist:g2,seg4,bf,pl"
    jres = jpipe.process_1(mappers, events, trajs, 0.5, stereo_fusion=2,
                           vopts=jpipe.VotingOptions(packet_size=packet_size, backend=spec))
    jdm = jmapper.get_depth_map(mappers[0], jres.fused_dsi, jex.DepthMapOptions())
    tm = [convert.mapper(m) for m in mappers]
    tres = tpipe.process_1(tm, [convert.events(e) for e in events],
                           [convert.trajectory(t, "cpu") for t in trajs], 0.5, stereo_fusion=2,
                           vopts=tpipe.VotingOptions(packet_size=packet_size, backend=spec))
    tdm = tmapper.get_depth_map(tm[0], tres.fused_dsi, tex.DepthMapOptions())
    want = np.asarray(jres.fused_dsi, np.float64)
    got = to_np(tres.fused_dsi).astype(np.float64)
    assert np.abs(got - want).sum() / np.abs(want).sum() < 1e-2
    for c in range(2):
        jm = float(np.asarray(jres.dsis[f"camera{c}"], np.float64).sum())
        assert abs(float(tres.dsis[f"camera{c}"].double().sum()) / jm - 1) < 0.005
    both = (to_np(tdm.mask) > 0) & (np.asarray(jdm.mask) > 0)
    assert both.sum() > 100
    d = np.abs(to_np(tdm.depth_indices) - np.asarray(jdm.depth_indices))[both]
    assert np.mean(d <= 1) >= 0.99


@pytest.mark.parametrize("rectify,pad", [("device", "none"), ("lut", "bucket")])
def test_evaluate_dsi_scatter_matches_jax(graft, rectify, pad):
    """The exact backend through the mapper: the same f32 arithmetic on
    both sides, so the DSIs agree to 1e-4 in relative L1 (votes of events
    whose warped position differs by an ulp across a pixel edge move)."""
    mappers, events, trajs, T_rv_w, packet_size = graft
    want = np.asarray(jmapper.evaluate_dsi(
        mappers[0], events[0], trajs[0], T_rv_w, packet_size=packet_size,
        rectify=rectify, pad=pad))
    got = to_np(tmapper.evaluate_dsi(
        convert.mapper(mappers[0]), convert.events(events[0]),
        convert.trajectory(trajs[0], "cpu"), convert.se3(T_rv_w, "cpu"), packet_size=packet_size,
        rectify=rectify, pad=pad))
    assert np.abs(got - want).sum() / np.abs(want).sum() < 1e-4
    assert tmapper.bucket_capacity(events[0].num, packet_size) == \
        jmapper.bucket_capacity(events[0].num, packet_size)


def test_small_chunk_votes_nothing(graft):
    mappers, events, trajs, T_rv_w, packet_size = graft
    ev = convert.events(events[0])
    tiny = tmapper.Events(ev.x[:packet_size], ev.y[:packet_size], ev.t[:packet_size])
    assert tmapper.evaluate_dsi(convert.mapper(mappers[0]), tiny,
                                convert.trajectory(trajs[0], "cpu"),
                                convert.se3(T_rv_w, "cpu"), packet_size=packet_size) is None


def test_place_reference_view_matches_jax(graft):
    _, _, trajs, _, _ = graft
    J = jpipe.place_reference_view(trajs[0], 0.5, rv_pos=0.3)
    T = tpipe.place_reference_view(convert.trajectory(trajs[0], "cpu"), 0.5, rv_pos=0.3)
    np.testing.assert_allclose(to_np(T.t), np.asarray(J.t), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to_np(T.q), np.asarray(J.q), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        tpipe.place_reference_view(convert.trajectory(trajs[0], "cpu"), 5.0)
