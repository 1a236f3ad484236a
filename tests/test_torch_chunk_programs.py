"""The whole-chunk programs of the port on the CPU: process_1 +
get_depth_map against the JAX package's jitted chunk (`__graft_entry__`),
the bodies that the card captures (the extraction under every collapse
method and past 256 planes, the fusion, the temporal step, the reference
view) making no host read, events given as tensors, the programs' keys and
caches, and the one work model that chip_smoke.py phase 3 and
scripts/roofline_torch.py share.

On the CPU the bodies run eagerly; the capture and the replay are checked
by chip_smoke.py phase 13 on the card.
"""

import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch
from test_torch_programs import HostRead, _graft_fixture, _refuse_host_reads

from dvs_mcemvs_torch import convert, graphs, mapper as tmapper, pipeline as tpipe
from dvs_mcemvs_torch.mapper import Events
from dvs_mcemvs_torch.ops import extract as tex, grid as tgrid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

# The JAX jit against the port's eager chunk: the same f32 arithmetic on the
# same events; an ulp may move a vote across a pixel edge, so indices and
# mask agree on >= 99.9 % of the pixels and the confidence within 1e-5 of
# its largest value.
EQUAL_SHARE, CONF_REL = 0.999, 1e-5
COLLAPSE_METHODS = (-1, 0, 1, 2, 3, 4)


@pytest.fixture(scope="module")
def graft():
    return _graft_fixture()


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_chunk_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _graft_entry():
    spec = importlib.util.spec_from_file_location(
        "_graft_entry_chunk", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_rig(graft):
    mappers, events, trajs, _, packet_size = graft
    return ([convert.mapper(m) for m in mappers], [convert.events(e) for e in events],
            [convert.trajectory(t, "cpu") for t in trajs], packet_size)


# ---------------------------------------------------------------------------
# The whole chunk against the JAX jit
# ---------------------------------------------------------------------------


def test_whole_chunk_matches_the_jax_jit(graft):
    """`__graft_entry__.entry()`'s jitted forward (2 cameras, exact scatter,
    HM fusion, argmax collapse, extraction) against the port's process_1 +
    get_depth_map on the same truncated events, on the CPU."""
    forward, args = _graft_entry().entry()
    depth, conf, mask = (np.asarray(a) for a in jax.jit(forward)(*args))
    mappers, events, trajs, packet_size = _port_rig(graft)
    n = args[0].shape[1]
    cut = [Events(e.x[:n], e.y[:n], e.t[:n]) for e in events]
    vopts = tpipe.VotingOptions(packet_size=packet_size, backend="scatter", pad_policy="none")
    res = tpipe.process_1(mappers, cut, trajs, 0.5, stereo_fusion=2, vopts=vopts)
    dm = tmapper.get_depth_map(mappers[0], res.fused_dsi, tex.DepthMapOptions())
    got_mask = dm.mask.numpy()
    assert float(np.mean(got_mask == mask)) >= EQUAL_SHARE
    keep = (got_mask > 0) & (mask > 0)
    assert keep.sum() > 50
    assert float(np.mean(np.abs(dm.depth.numpy()[keep] - depth[keep])
                         <= 1e-5 * depth[keep])) >= EQUAL_SHARE
    assert float(np.abs(dm.confidence.numpy() - conf).max()) <= CONF_REL * float(conf.max())


# ---------------------------------------------------------------------------
# The bodies the card captures: no host read, the eager path's bits
# ---------------------------------------------------------------------------


def _dsi(Z=20, H=48, W=64, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.gamma(0.5, 2.0, (Z, H, W)), dtype=torch.float32)


@pytest.mark.parametrize("case", [f"collapse{m}" for m in COLLAPSE_METHODS] + ["300planes"])
def test_extraction_body_makes_no_host_read(monkeypatch, case):
    """`extract.extraction_body` (the extraction program's body) under every
    collapse method, and on a 300-plane DSI (the gather + sort median), runs
    with every host read refused and returns `get_depth_map_from_dsi`'s maps
    to the bit.  A first run builds the padding tables, as the program's
    warm-up does."""
    Z, method = (300, -1) if case == "300planes" else (20, int(case[len("collapse"):]))
    dsi = _dsi(Z)
    dv = tmapper.DepthVector("linear", 1.0, 4.0, Z)
    opts = tex.DepthMapOptions(collapse_method=method)
    want = tex.get_depth_map_from_dsi(dsi, dv, opts)
    with monkeypatch.context() as m:
        _refuse_host_reads(m)
        got = tex.extraction_body(dsi, dv, opts)
    assert set(got) == set(tex.MAP_NAMES)
    for name in tex.MAP_NAMES:
        assert torch.equal(got[name], getattr(want, name)), name


@pytest.mark.parametrize("method", [1, 2, 3, 4, 5, 6])
def test_fusion_body_makes_no_host_read(monkeypatch, method):
    grids = [_dsi(seed=s) for s in range(3)]
    want = tgrid.fuse_many(grids, method)
    with monkeypatch.context() as m:
        _refuse_host_reads(m)
        got = tgrid.fuse_many(grids, method)
    assert torch.equal(got, want)


def _previous_temporal(dsis, stereo_fusion, method):
    """The accumulators as process_time_fusion kept them before its
    programs: the first term alone, then added in place."""
    acc = [None, None, None]
    for d0, d1 in dsis:
        for i, d in enumerate((tgrid.fuse_pair(d0, d1, stereo_fusion), d0, d1)):
            if method == tpipe.TEMPORAL_HM:
                acc[i] = tgrid.inverse(d) if acc[i] is None else tgrid.add_inverse_(acc[i], d)
            else:
                acc[i] = d.clone() if acc[i] is None else tgrid.fuse_add_(acc[i], d)
    n = len(dsis)
    fin = [tgrid.hm_from_sum_of_inv(a, n) if method == tpipe.TEMPORAL_HM
           else tgrid.am_from_sum(a, n) for a in acc]
    return dict(zip(("fused", "left", "right"), fin),
                camera_time=tgrid.fuse_pair(fin[1], fin[2], stereo_fusion))


@pytest.mark.parametrize("method", [tpipe.TEMPORAL_AM, tpipe.TEMPORAL_HM], ids=["AM", "HM"])
def test_temporal_bodies_make_no_host_read(monkeypatch, method):
    """`temporal_step` (first and later sub-intervals) and `temporal_final`
    with every host read refused give the previous accumulators' bits."""
    dsis = [(_dsi(seed=2 * k), _dsi(seed=2 * k + 1)) for k in range(3)]
    want = _previous_temporal(dsis, 2, method)
    acc = [torch.empty_like(dsis[0][0]) for _ in range(3)]
    with monkeypatch.context() as m:
        _refuse_host_reads(m)
        for k, (d0, d1) in enumerate(dsis):
            fused_k = tpipe.temporal_step(acc, d0, d1, 2, method, first=k == 0)
            assert torch.equal(fused_k, tgrid.fuse_pair(d0, d1, 2))
        got = tpipe.temporal_final(acc, len(dsis), 2, method)
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_reference_view_body_makes_no_host_read(graft, monkeypatch):
    """The reference view's program body on a device scalar time gives
    `place_reference_view`'s pose to the bit, with every host read
    refused."""
    _, _, trajs, _ = _port_rig(graft)
    want = tpipe.place_reference_view(trajs[0], 0.5, 0.1)
    t = torch.tensor(0.5, dtype=trajs[0].ts.dtype)
    shift = tpipe.SE3(torch.tensor([1.0, 0.0, 0.0, 0.0]), torch.tensor([0.1, 0.0, 0.0]))
    with monkeypatch.context() as m:
        _refuse_host_reads(m)
        got = tpipe._placement(trajs[0], t, shift)
    assert torch.equal(got.q, want.q) and torch.equal(got.t, want.t)


def test_the_guard_refuses_a_number_assigned_to_a_tensor(monkeypatch):
    """The guard catches what the first capture of a sharded step refused:
    a Python number assigned into a tensor is a copy from the host."""
    t = torch.zeros(2, 2)
    with monkeypatch.context() as m:
        _refuse_host_reads(m)
        t[0, 0].fill_(1.0)
        with pytest.raises(HostRead):
            torch.as_tensor(np.float32(1.0))


def test_process_time_fusion_keeps_its_outputs(graft):
    """process_2 on the CPU (the temporal bodies run eagerly) gives the
    previous accumulators' DSIs, and `on_subinterval` sees fresh tensors
    that later sub-intervals leave as they were."""
    mappers, events, trajs, packet_size = _port_rig(graft)
    vopts = tpipe.VotingOptions(packet_size=packet_size, backend="hist:g4,seg4,bf,pl")
    seen = []
    res = tpipe.process_2(mappers, events, trajs, 0.5, stereo_fusion=2,
                          temporal_fusion=tpipe.TEMPORAL_HM, num_intervals=3, vopts=vopts,
                          on_subinterval=lambda k, d: seen.append(
                              {n: (t, t.clone()) for n, t in d.items()}))
    pairs = [(s["camera0"][1], s["camera1"][1]) for s in seen]
    want = _previous_temporal(pairs, 2, tpipe.TEMPORAL_HM)
    assert torch.equal(res.fused_dsi, want["fused"])
    assert torch.equal(res.dsis["left_temporal"], want["left"])
    assert torch.equal(res.dsis["camera_time"], want["camera_time"])
    for s in seen:
        for name, (t, kept) in s.items():
            assert torch.equal(t, kept), name
    assert len(tpipe.temporal_programs()) == 0       # the CPU makes no program


# ---------------------------------------------------------------------------
# Events as tensors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pad", ["none", "bucket"])
def test_tensor_events_give_the_host_events_dsi(graft, pad):
    """Events of CPU tensors (int64 pixels, float64 times, staged by torch
    ops on the trajectory's device) vote the DSI that the same numpy events
    vote, for both cameras; their warp too."""
    mappers, events, trajs, packet_size = _port_rig(graft)
    _, _, _, T_rv_w, _ = graft
    T = convert.se3(T_rv_w, "cpu")
    kw = dict(packet_size=packet_size, backend="hist:g4,seg4,bf,pl", pad=pad)
    for m, ev, tr in zip(mappers, events, trajs):
        ev = ev.slice(0, 3000)
        as_t = Events(torch.as_tensor(np.asarray(ev.x, np.int64)),
                      torch.as_tensor(np.asarray(ev.y, np.int64)),
                      torch.as_tensor(np.asarray(ev.t, np.float64)))
        assert tmapper._on_device(as_t, tr.device)
        want = tmapper.evaluate_dsi(m, ev, tr, T, **kw)
        got = tmapper.evaluate_dsi(m, as_t, tr, T, **kw)
        assert torch.equal(got, want)
        wp, _, _ = tmapper.warp_chunk(m, as_t, tr, T, packet_size, pad=pad)
        hp, _, _ = tmapper.warp_chunk(m, ev, tr, T, packet_size, pad=pad)
        assert torch.equal(wp.xy_z0, hp.xy_z0)
    tmapper.check_faults()


def test_tensor_events_slice_and_window_as_arrays(graft):
    """`Events.slice` and `time_window` on tensors select the events that
    they select on the host arrays (bounds in the times' dtype)."""
    _, events, _, _ = _port_rig(graft)
    ev = events[0]
    t32 = Events(ev.x, ev.y, np.asarray(ev.t, np.float32))
    for host in (ev, t32):
        as_t = Events(*(torch.as_tensor(np.asarray(a)) for a in (host.x, host.y, host.t)))
        for t0, t1 in ((0.1, 0.4), (float(host.t[100]), float(host.t[900])), (-1.0, 0.0),
                       (0.3, 9.0)):
            a, b = host.time_window(t0, t1), as_t.time_window(t0, t1)
            assert a.num == b.num
            np.testing.assert_array_equal(b.t.numpy(), a.t)
        np.testing.assert_array_equal(as_t.slice(5, 50).x.numpy(), host.slice(5, 50).x)


def test_events_on_another_device_raise(graft):
    """Tensors on a device other than the trajectory's (here "meta" beside
    a CPU trajectory), or pixels as arrays beside times as tensors, are
    refused before anything is staged; CPU tensors beside a card's
    trajectory take the host path."""
    mappers, events, trajs, packet_size = _port_rig(graft)
    T = convert.se3(graft[3], "cpu")
    ev = events[0].slice(0, 3000)
    meta = Events(*(torch.empty(ev.num, device="meta") for _ in range(3)))
    with pytest.raises(ValueError, match="trajectory's device"):
        tmapper.evaluate_dsi(mappers[0], meta, trajs[0], T, packet_size=packet_size)
    mixed = Events(ev.x, ev.y, torch.as_tensor(np.asarray(ev.t)).to("meta"))
    with pytest.raises(ValueError, match="trajectory's device"):
        tmapper.warp_chunk(mappers[0], mixed, trajs[0], T, packet_size)
    cpu_t = Events(*(torch.as_tensor(np.asarray(a)) for a in (ev.x, ev.y, ev.t)))
    assert not tmapper._on_device(cpu_t, torch.device("cuda", 0))
    assert not tmapper._on_device(ev, torch.device("cpu"))


# ---------------------------------------------------------------------------
# Keys and caches
# ---------------------------------------------------------------------------


def test_extraction_keys_follow_their_static_arguments():
    dsi = _dsi()
    dv = tmapper.DepthVector("linear", 1.0, 4.0, 20)
    opts = tex.DepthMapOptions()
    key = tmapper.extraction_key(dsi, dv, opts)
    assert key == tmapper.extraction_key(_dsi(seed=5), dv, tex.DepthMapOptions())
    for other in (tmapper.extraction_key(_dsi(Z=21), dv, opts),
                  tmapper.extraction_key(dsi.double(), dv, opts),
                  tmapper.extraction_key(dsi, tmapper.DepthVector("inverse", 1.0, 4.0, 20),
                                         opts),
                  tmapper.extraction_key(dsi, dv, tex.DepthMapOptions(collapse_method=2)),
                  tmapper.extraction_key(dsi, dv, tex.DepthMapOptions(
                      adaptive_threshold_kernel_size=7)),
                  tmapper.extraction_key(dsi, dv, tex.DepthMapOptions(max_confidence=9.0))):
        assert other != key


def test_fusion_and_temporal_keys_follow_their_static_arguments():
    g = [_dsi(), _dsi(seed=1)]
    key = tpipe.fusion_key(g, 2)
    assert key == tpipe.fusion_key([_dsi(seed=3), _dsi(seed=4)], 2)
    assert key != tpipe.fusion_key(g, 4)
    assert key != tpipe.fusion_key(g + [_dsi(seed=2)], 2)
    assert key != tpipe.fusion_key([_dsi(Z=21), _dsi(Z=21)], 2)
    tkey = tpipe.temporal_key(g[0], 2, tpipe.TEMPORAL_AM)
    assert tkey == tpipe.temporal_key(g[1], 2, tpipe.TEMPORAL_AM)
    assert tkey != tpipe.temporal_key(g[0], 2, tpipe.TEMPORAL_HM)
    assert tkey != tpipe.temporal_key(g[0], 1, tpipe.TEMPORAL_AM)
    assert tkey != tpipe.temporal_key(_dsi(H=40), 2, tpipe.TEMPORAL_AM)


@pytest.mark.parametrize("cache,size", [
    (tmapper._EXTRACTIONS, tmapper.EXTRACTION_CACHE_SIZE),
    (tpipe._FUSIONS, tpipe.FUSION_CACHE_SIZE),
    (tpipe._TEMPORAL, tpipe.TEMPORAL_CACHE_SIZE),
    (tpipe._PLACEMENTS, tpipe.PLACEMENT_CACHE_SIZE),
], ids=["extraction", "fusion", "temporal", "placement"])
def test_whole_chunk_caches_drop_the_least_recently_used(cache, size):
    closed = []

    class Fake:
        def __init__(self, name):
            self.name = name

        def close(self):
            closed.append(self.name)

    assert cache.size == size and len(cache) == 0     # the CPU makes no program
    try:
        for i in range(size):
            cache.put(("k", i), Fake(i))
        cache.get(("k", 0))
        cache.put(("k", size), Fake(size))
        assert closed == [1] and cache.keys()[-2:] == [("k", 0), ("k", size)]
    finally:
        cache.clear()
    assert len(cache) == 0


def test_a_program_whose_first_call_raises_is_not_kept():
    """`ProgramCache.call` keeps a program only once its first call (the
    capture on the card) returned; later calls reuse it."""
    made = []

    class Prog:
        def __init__(self, fail):
            self.fail = fail
            made.append(self)

        def __call__(self, x):
            if self.fail:
                raise RuntimeError("capture refused")
            return x + 1

        def close(self):
            pass

    cache = graphs.ProgramCache(2)
    with pytest.raises(RuntimeError, match="capture refused"):
        cache.call("k", lambda: Prog(True), 1)
    assert len(cache) == 0
    assert cache.call("k", lambda: Prog(False), 1) == 2
    assert cache.call("k", lambda: Prog(True), 2) == 3
    assert len(made) == 2 and len(cache) == 1


def test_the_caches_fit_a_run_at_the_headline_size():
    """Full caches at the headline DSI (640x480x100 float32): chunk
    programs (a DSI and the event buffers each), extraction programs (a
    static DSI), fusion programs (two cameras and the fused DSI), temporal
    programs (2 inputs, 3 accumulators, 4 finalised and 1 fused output)
    hold under a fifth of the card's 80 GB."""
    dsi = 100 * 480 * 640 * 4
    events = 4 * 4 * chip_smoke.N_EVENTS
    held = (tmapper.PROGRAM_CACHE_SIZE * (dsi + events) + tmapper.EXTRACTION_CACHE_SIZE * dsi
            + tpipe.FUSION_CACHE_SIZE * 3 * dsi + tpipe.TEMPORAL_CACHE_SIZE * 10 * dsi)
    assert held < 16e9


def test_cpu_makes_no_whole_chunk_program(graft):
    """On the CPU process_1 + get_depth_map run their bodies eagerly,
    inside `eager()` or not, to the same bits."""
    mappers, events, trajs, packet_size = _port_rig(graft)
    vopts = tpipe.VotingOptions(packet_size=packet_size, backend="hist:g4,seg4,bf,pl")

    def chunk():
        res = tpipe.process_1(mappers, events, trajs, 0.5, stereo_fusion=2, vopts=vopts)
        return res.fused_dsi, tmapper.get_depth_map(mappers[0], res.fused_dsi,
                                                    tex.DepthMapOptions())

    fused, dm = chunk()
    with graphs.eager():
        fused_e, dm_e = chunk()
    assert torch.equal(fused, fused_e) and torch.equal(dm.depth_indices, dm_e.depth_indices)
    held = (tmapper.extraction_programs(), tpipe.fusion_programs(), tpipe.temporal_programs(),
            tpipe._PLACEMENTS.values())
    assert all(len(h) == 0 for h in held)


def test_fresh_copies_every_tensor():
    q, t = torch.ones(4), torch.zeros(3)
    out = graphs.fresh({"a": [q, (t,)], "se3": tpipe.SE3(q, t), "n": 3})
    assert out["n"] == 3 and isinstance(out["se3"], tpipe.SE3)
    for got, src in ((out["a"][0], q), (out["a"][1][0], t), (out["se3"].q, q)):
        assert torch.equal(got, src) and got.data_ptr() != src.data_ptr()


# ---------------------------------------------------------------------------
# One work model
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_phase_3_and_the_roofline_share_one_work_model():
    """scripts/roofline_torch.py's model gives phase 3's bytes and
    operations for kernel rows 1-3 at the headline shapes, as phase 3
    counted them from its tensors before the model moved (binning 64 x
    16,384 events into 64 x 576 x 896 bf16; a radix-4 merge level of 64
    items x 4 sources; the sweep of 16 segments x 7 planes x 4 sources into
    100 x 480 x 640 f32); and chip_smoke.py keeps no model of its own."""
    rl = _load("roofline_torch")
    G, E, hs, ws, Z, Ho, Wo, S, K, M = 64, 16384, 576, 896, 100, 480, 640, 16, 4, 7
    live = 943_718
    nb = rl.nbytes
    bf16 = torch.bfloat16
    # row 1: nbytes(hx, hy, w) + out_bytes, 8 x live
    want = (nb(_meta(G, E), _meta(G, E), _meta(G, E)) + G * hs * ws * 2, 8 * live)
    assert rl.binning_work(G, E, hs, ws, 2, live) == want
    # row 2: nbytes(hist, sy, ty, tx, src, out), resample_ops(src.size, hs, ws, ws)
    N = G
    want = (nb(_meta(G, hs, ws, dtype=bf16), _meta(N, K), _meta(N, K), _meta(N, K),
               _meta(N, K, dtype=torch.int32), _meta(N, hs, ws, dtype=bf16)),
            N * K * 4 * (hs * ws + hs * ws))
    assert rl.resample_sum_work(G, hs, ws, 2, N, K, hs, ws, 2) == want
    # row 3: nbytes(blocks, sy, ty, sx, tx, out) + out_idx.size x 4,
    # resample_ops(planes x K, Ho, ws, Wo)
    want = (nb(_meta(S, K, hs, ws, dtype=bf16), *[_meta(S, M, K)] * 4, _meta(Z, Ho, Wo))
            + S * M * 4, Z * K * 4 * (Ho * ws + Ho * Wo))
    assert rl.resample_fanin_work(S, K, hs, ws, 2, M, Z, Z, Ho, Wo) == want
    assert rl.bound(3.35e9, 0) == {"bound_ms": 1.0, "bound_by": "bytes"}
    assert rl.bound(0, 67e9) == {"bound_ms": 1.0, "bound_by": "operations"}
    assert chip_smoke.work_model().binning_work(G, E, hs, ws, 2, live) == \
        rl.binning_work(G, E, hs, ws, 2, live)
    for name in ("bound", "nbytes", "resample_ops", "HBM_BYTES_PER_S", "F32_OPS_PER_S"):
        assert not hasattr(chip_smoke, name), name


def test_the_roofline_stages_record_the_chunks_kernel_work():
    """On a small chunk the roofline's stages (run in turn) give the mapper
    body's DSI, and each kernel stage's model sums the work of the kernel
    calls it records; the whole chunk's includes both cameras, the fusion
    and the extraction."""
    rl = _load("roofline_torch")
    workload = chip_smoke.build_workload(torch.device("cpu"), n_events=16384, width=96,
                                         height=64, dim_z=20, n_pts=2000)
    st = rl.Stages(workload, "hist:g4,seg4,bf,pl")
    st.check()
    work = st.work()
    Z, H, W = st.shape
    assert work["sweep"][0] >= Z * H * W * 4
    assert work["fusion"] == rl.fusion_work(2, Z * H * W, 2)
    per_camera = sum(work[k][0] for k in ("warp", "binning", "merge", "sweep"))
    assert work["chunk"][0] == pytest.approx(
        2 * per_camera + work["fusion"][0] + work["extraction"][0], rel=0.05)
    with pytest.raises(ValueError, match="butterfly"):
        rl.Stages(workload, "hist:g4,seg4,pl")


def test_chip_smoke_whole_chunk_rehearses_on_cpu():
    """Phase 13's steps at a small size on the CPU, where no program is
    made: the whole chunk, every collapse method and a 30-plane chunk,
    process_2 AM and HM, and events as tensors, each against eager."""
    cpu = torch.device("cpu")
    workload = chip_smoke.build_workload(cpu, n_events=16384, width=96, height=64, dim_z=20,
                                         n_pts=2000)
    spec = "hist:g4,seg4,bf,pl"
    out = chip_smoke.whole_chunk_phase(cpu, workload, {}, {}, specs=(spec, "scatter"),
                                       spec=spec, dim_z=30)
    assert out[spec]["graphs"] == 0 and out["temporal"]["AM"]["graphs"] == 0
    assert set(out["extraction"]) == {f"collapse_method {m}" for m in COLLAPSE_METHODS} | {
        "30 planes"}
    assert out["events"]["chunk_card_s"] > 0
