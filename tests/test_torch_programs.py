"""The port's chunk program (`mapper.evaluate_dsi`, the counterpart of the
JAX package's `_evaluate_dsi_jit`) on the CPU: parity with the JAX program
over bucket shapes and backends, a body that makes no host read, the cached
kernel-B tables, the static-shape `splat_sort`, the deferred weight checks,
the host-side reference-view check, and the program keys and cache.

On the CPU the body runs eagerly (no CUDA graph); what the card adds, the
capture and the replay, is checked by `chip_smoke.py` phase 12.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
from _torch_util import to_np

from dvs_mcemvs_tpu import mapper as jmapper
from dvs_mcemvs_tpu.ops import voting as jvoting
from dvs_mcemvs_torch import convert, mapper as tmapper, pipeline as tpipe
from dvs_mcemvs_torch.kernels import binning, resample
from dvs_mcemvs_torch.ops import extract as tex, trajectory as ttraj, voting as tvoting

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

# The backends of the parity and host-read tests, with the tolerance of
# their existing parity tests: `scatter` through the mapper 1e-4 relative
# L1 (tests/test_torch_pipeline.py: the same f32 arithmetic, an ulp moves a
# vote across a pixel edge); `sort` and the hist specs relative L1 < 1e-2
# and vote mass within 0.5 % (tests/test_torch_voting_hist.py: bf16
# roundings flipped by f32 summation order).
BACKENDS = {"scatter": 1e-4, "sort": 1e-2, "hist:g4,seg4,bf,pl": 1e-2,
            "hist:g4,seg4,i8,pl": 1e-2, "hist:g4,ss2,seg5": 1e-2}
MASS_REL = 0.005
# Chunk sizes of the graft rig (128-event packets): three in the 4096-event
# bucket (18, 24 and 32 packets), one in the next (33 packets).
CHUNKS = (2200, 3000, 4000, 4200)


def _graft_fixture():
    spec = importlib.util.spec_from_file_location(
        "_graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._fixture()


@pytest.fixture(scope="module")
def graft():
    return _graft_fixture()


@pytest.mark.parametrize("n", CHUNKS)
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_evaluate_dsi_matches_the_jax_program(graft, backend, n):
    """pad="bucket": the chunk's first n events of camera 1 (the one
    whose trajectory is composed with the baseline) through both packages'
    `evaluate_dsi`; the JAX package jits one program per bucket shape."""
    mappers, events, trajs, T_rv_w, packet_size = graft
    ev = events[1].slice(0, n)
    kw = dict(packet_size=packet_size, backend=backend, pad="bucket")
    want = np.asarray(jmapper.evaluate_dsi(mappers[1], ev, trajs[1], T_rv_w, **kw), np.float64)
    got = to_np(tmapper.evaluate_dsi(convert.mapper(mappers[1]), convert.events(ev),
                                     convert.trajectory(trajs[1], "cpu"),
                                     convert.se3(T_rv_w, "cpu"), **kw)).astype(np.float64)
    tmapper.check_faults()
    assert got.shape == want.shape
    l1 = np.abs(got - want).sum() / np.abs(want).sum()
    assert l1 < BACKENDS[backend], f"relative L1 {l1:.3g}"
    assert abs(got.sum() / want.sum() - 1) < MASS_REL


def _body_inputs(graft, backend, n=3000):
    """The body's arguments for the first n events of camera 0, staged as
    `evaluate_dsi` stages them (pad="bucket")."""
    mappers, events, trajs, T_rv_w, packet_size = graft
    m = convert.mapper(mappers[0])
    body = tmapper._setup(m, packet_size, backend, 8, "device")
    dev = torch.device("cpu")
    x, y, t, w = tmapper._device_events(convert.events(events[0].slice(0, n)), packet_size,
                                        "bucket", dev)
    return (body, tmapper._constants(m, body, dev), x, y, t, w,
            convert.trajectory(trajs[0], "cpu"), convert.se3(T_rv_w, "cpu"))


class HostRead(AssertionError):
    pass


def _refuse_host_reads(monkeypatch):
    """Make every host read of a tensor, and every tensor built from host
    data, raise."""
    def refuse(name):
        def fn(*args, **kwargs):
            raise HostRead(name)
        return fn

    for name in ("item", "tolist", "__bool__", "__int__", "__float__", "numpy", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))
    monkeypatch.setattr(torch, "nonzero", refuse("torch.nonzero"))
    for mod, name in ((torch, "as_tensor"), (torch, "tensor"), (torch, "from_numpy"),
                      (torch.Tensor, "new_tensor")):
        real = getattr(mod, name)

        def guarded(*args, _real=real, _name=name, **kwargs):
            data = args[1] if _name == "new_tensor" else args[0]
            if not isinstance(data, torch.Tensor):
                raise HostRead(f"{_name} on host data")
            return _real(*args, **kwargs)

        monkeypatch.setattr(mod, name, guarded)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_the_body_makes_no_host_read(graft, monkeypatch, backend):
    """The body that a program captures (warp and vote, with deferred weight
    checks) runs to its end with every host read refused, and votes what it
    votes without the refusal.  Run before the body has its tables: a table
    is built from host arrays, so the first run builds them and the second,
    refused, reads them from the cache."""
    args = _body_inputs(graft, backend)
    flag = binning.fault_flag("cpu")
    with binning.deferred_weight_checks(flag):
        want = tmapper._vote(*args)
        with monkeypatch.context() as m:
            _refuse_host_reads(m)
            got = tmapper._vote(*args)
    assert torch.equal(got, want)
    assert not flag.any()


def test_host_read_guard_refuses_what_a_graph_cannot_hold(monkeypatch):
    """The guard above catches each kind of host read it names."""
    t = torch.ones(3)
    with monkeypatch.context() as m:
        _refuse_host_reads(m)
        for fn in (lambda: t.sum().item(), lambda: bool(t.any()), lambda: t.tolist(),
                   lambda: torch.nonzero(t), lambda: torch.as_tensor(np.ones(2)),
                   lambda: t.new_tensor([1.0, 2.0]), lambda: torch.tensor([1.0])):
            with pytest.raises(HostRead):
                fn()
        torch.as_tensor(t)      # a tensor passes


# ---------------------------------------------------------------------------
# Kernel B's tables: the cache against the host tables built per call before
# ---------------------------------------------------------------------------


def _old_fanin(out_idx, K):
    """`resample.fanin_items` of the parent: one item per plane, its last
    writer (src_idx, out_idx, row of the flattened maps)."""
    flat = np.asarray(out_idx).reshape(-1)
    M = np.asarray(out_idx).shape[1]
    _, first_rev = np.unique(flat[::-1], return_index=True)
    pos = flat.size - 1 - first_rev
    return (pos // M)[:, None] * K + np.arange(K)[None, :], flat[pos], pos


def _old_tables(key):
    """The host tables that the parent built per call for a cache key."""
    kind = key[0]
    if kind == "sum":
        N, K, blocked = key[1:]
        src = np.arange(K)[None, :] + (np.arange(N)[:, None] * K if blocked else 0)
        return np.broadcast_to(src, (N, K)), np.arange(N), None
    if kind == "butterfly-sum":
        R, N, N_prev, radix = key[1:]
        rs = np.arange(R)[:, None, None]
        ns = np.arange(N)[None, :, None]
        ks = np.arange(radix)[None, None, :]
        return ((rs // radix) * N_prev + radix * ns + ks).reshape(R * N, radix), \
            np.arange(R * N), None
    if kind == "butterfly-fanin":
        R_prev, N, radix = key[1:]
        qs = np.arange(R_prev)[:, None, None]
        ns = np.arange(N)[None, :, None]
        js = np.arange(radix)[None, None, :]
        return _old_fanin(((qs * radix + js) * N + ns).reshape(R_prev * N, radix), radix)
    bounds = key[1]
    S = len(bounds) - 1
    seg_lens = [bounds[s + 1] - bounds[s] for s in range(S)]
    M = max(seg_lens)
    pidx = np.stack([np.minimum(bounds[s] + np.arange(M), bounds[s + 1] - 1)
                     for s in range(S)]).astype(np.int32)
    if kind == "sweep-planes":
        return pidx
    assert kind == "sweep-fanin", key
    return _old_fanin(pidx, key[2])


SMALL_FORMS = [spec.replace("g16", "g4").replace("seg16", "seg4")
               for spec in [chip_smoke.HEADLINE_SPEC, *chip_smoke.SPEC_FORMS]]


@pytest.mark.parametrize("spec", SMALL_FORMS)
def test_cached_tables_equal_the_host_tables(graft, monkeypatch, spec):
    """Every table that a chunk under each spec form of chip_smoke.py
    fetches equals, element for element, what the parent built on the host
    at each call; two chunks build each key once."""
    resample._TABLES.clear()
    fetched, built = {}, {}
    real = resample._cached

    def spy(key, device, make):
        def counted():
            built[key] = built.get(key, 0) + 1
            return make()
        table = real(key, device, counted)
        fetched[key] = table
        return table

    monkeypatch.setattr(resample, "_cached", spy)
    args = _body_inputs(graft, spec)
    with binning.deferred_weight_checks(binning.fault_flag("cpu")):
        tmapper._vote(*args)
        tmapper._vote(*args)
    if spec == "sort":
        assert not fetched
        return
    assert fetched and all(n == 1 for n in built.values()), built
    for key, table in fetched.items():
        want = _old_tables(key)
        if key[0] == "sweep-planes":
            np.testing.assert_array_equal(to_np(table), want)
            continue
        src_idx, out_idx, sel = want
        np.testing.assert_array_equal(to_np(table.src_idx), src_idx)
        np.testing.assert_array_equal(to_np(table.out_idx), out_idx)
        if sel is None:
            assert table.sel is None
        else:
            np.testing.assert_array_equal(to_np(table.sel), sel)
        assert table.src_idx.dtype == torch.int32 and table.src_idx.is_contiguous()


def test_host_arrays_share_the_cache():
    """A host index array reaches the kernel through the cache by its
    contents: equal arrays fetch one table, and a later change to the
    caller's array does not reach the cached copy."""
    resample._TABLES.clear()
    hist = torch.rand(4, 16, 32)
    maps = [torch.ones(2, 2), torch.zeros(2, 2)]
    src = np.array([[0, 1], [2, 3]])
    a = resample.banded_resample_sum(hist, maps[0], maps[1], maps[0], maps[1], out_h=8,
                                     out_w=16, blocked=True, src=src)
    n = len(resample._TABLES)
    b = resample.banded_resample_sum(hist, maps[0], maps[1], maps[0], maps[1], out_h=8,
                                     out_w=16, blocked=True, src=src.copy())
    assert len(resample._TABLES) == n and torch.equal(a, b)
    src[0, 0] = 3
    (table,) = [t for k, t in resample._TABLES.items() if k[0][0] == "sum-src"]
    assert int(table.src_idx[0, 0]) == 0
    with pytest.raises(ValueError, match="source index out of range"):
        resample.banded_resample_sum(hist, maps[0], maps[1], maps[0], maps[1], out_h=8,
                                     out_w=16, blocked=True, src=np.array([[0, 1], [2, 4]]))


# ---------------------------------------------------------------------------
# splat_sort with fixed shapes
# ---------------------------------------------------------------------------


def _old_splat_sort(packets, depths, z0, vcam_params, width, height, plane_block=8):
    """The parent's `splat_sort` (run ends by `torch.nonzero`), the oracle."""
    fx, fy, cx, cy = vcam_params
    K, P, _ = packets.xy_z0.shape
    xy = packets.xy_z0.reshape(K * P, 2)
    pw = packets.event_weights()
    Z = depths.shape[0]
    HW = height * width
    key_dtype = torch.int32 if Z * HW < 2**31 else torch.int64
    out = torch.zeros(Z * HW, dtype=torch.float32)
    last = torch.ones(1, dtype=torch.bool)
    for z_lo in range(0, Z, plane_block):
        sl = slice(z_lo, min(z_lo + plane_block, Z))
        a, bx, by, d = (c.T.repeat_interleave(P, dim=1) for c in tvoting.eq15_coefficients(
            packets.centers, depths[sl], z0, fx, fy, cx, cy))
        X = (xy[None, :, 0] * a + bx) / d
        Y = (xy[None, :, 1] * a + by) / d
        idx4, w4 = tvoting.bilinear_corners(X, Y, width, height)
        plane = (z_lo + torch.arange(a.shape[0]))[:, None, None] * HW
        sidx, order = torch.sort((idx4 + plane).reshape(-1).to(key_dtype))
        csum = torch.cumsum((w4 * pw[None, :, None]).reshape(-1)[order].double(), 0)
        ends = torch.nonzero(torch.cat([sidx[1:] != sidx[:-1], last])).squeeze(1)
        out[sidx[ends].long()] = torch.diff(csum[ends], prepend=csum.new_zeros(1)).float()
    return out.reshape(Z, height, width)


def _heavy_packets(K=16, P=1024, W=346, H=260):
    rng = np.random.default_rng(5)
    xy = np.stack([rng.uniform(-20, W + 20, (K, P)), rng.uniform(-20, H + 20, (K, P))], -1)
    centers = np.stack([np.linspace(0, 0.05, K), np.zeros(K), np.zeros(K)], -1)
    w = rng.uniform(0, 30, (K, P)) * (rng.uniform(size=(K, P)) > 0.2)
    f32 = dict(dtype=torch.float32)
    return (tvoting.WarpedPackets(torch.as_tensor(xy, **f32), torch.as_tensor(centers, **f32),
                                  torch.as_tensor(rng.uniform(size=K) > 0.1),
                                  torch.as_tensor(w, **f32)),
            torch.linspace(2.0, 3.0, 12), (300.0, 300.0, W / 2, H / 2), W, H)


@pytest.mark.parametrize("case", ["camera0", "camera1", "weighted"])
def test_splat_sort_is_bitwise_the_previous_one(graft, case):
    """The fixed-shape run totals equal the parent's to the bit: the same
    float64 running sums, subtracted at the same run ends."""
    if case == "weighted":
        packets, depths, vp, W, H = _heavy_packets()
        z0 = float(depths[0])
    else:
        body, c, x, y, t, w, traj, T = _body_inputs(graft, "sort", n=4200)
        if case == "camera1":
            w = None
            n = (x.shape[0] // body.packet_size) * body.packet_size
            x, y, t = x[:n], y[:n], t[:n]
        packets = tmapper._warp(body, c, x, y, t, w, traj, T)
        depths, z0, vp, W, H = c.depths, body.z0, body.vcam_params, body.width, body.height
    got = tvoting.splat_sort(packets, depths, z0, vp, W, H, plane_block=5)
    want = _old_splat_sort(packets, depths, z0, vp, W, H, plane_block=5)
    assert torch.equal(got, want)
    assert float(got.sum()) > 0


# ---------------------------------------------------------------------------
# The weight checks, deferred to one read a chunk
# ---------------------------------------------------------------------------


REFUSED = {"binary-half": (True, False, 0.5, "not all 0 or 1"),
           "int8-over": (False, True, 1.5, r"weights in \[0, 1\]"),
           "int8-nan": (False, True, float("nan"), r"weights in \[0, 1\]")}


def _binning_args(bad):
    rng = np.random.default_rng(3)
    hx = torch.as_tensor(rng.uniform(0, 31, (2, 64)), dtype=torch.float32)
    hy = torch.as_tensor(rng.uniform(0, 15, (2, 64)), dtype=torch.float32)
    w = torch.ones(2, 64)
    w[1, 7] = bad
    return hx, hy, w


@pytest.mark.parametrize("case", list(REFUSED))
def test_refused_weights_raise_at_the_call(case):
    binary_w, int8, bad, message = REFUSED[case]
    with pytest.raises(ValueError, match=message):
        binning.bin_events(*_binning_args(bad), hs=16, ws=32, binary_w=binary_w, int8=int8)


@pytest.mark.parametrize("case", list(REFUSED))
def test_refused_weights_raise_through_the_flag(case):
    """Deferred, the call returns and the flag, read once, raises the same
    message; reading it clears it."""
    binary_w, int8, bad, message = REFUSED[case]
    flag = binning.fault_flag("cpu")
    with binning.deferred_weight_checks(flag):
        binning.bin_events(*_binning_args(bad), hs=16, ws=32, binary_w=binary_w, int8=int8)
        binning.bin_events(*_binning_args(1.0), hs=16, ws=32, binary_w=binary_w, int8=int8)
    with pytest.raises(ValueError, match=message):
        binning.raise_weight_faults(flag)
    binning.raise_weight_faults(flag)


@pytest.mark.parametrize("bad", [1.5, float("nan")], ids=["over", "nan"])
@pytest.mark.parametrize("sync", [False, True], ids=["extract", "sync"])
def test_a_chunk_of_refused_weights_never_becomes_a_depth_map(graft, monkeypatch, bad, sync):
    """Weights outside [0, 1] under int8 binning, staged into a process_1
    chunk: the vote returns (its check is deferred to the device flag), and
    the pipeline's sync (`vopts.sync`) or the extraction raises the binning's
    message before a depth map is handed back."""
    mappers, events, trajs, _, packet_size = graft
    real = tmapper._pad_device

    def pad_refused(x, y, t, w, n):
        real(x, y, t, w, n)
        w[n // 2] = bad

    monkeypatch.setattr(tmapper, "_pad_device", pad_refused)
    tm = [convert.mapper(m) for m in mappers]
    vopts = tpipe.VotingOptions(packet_size=packet_size, backend="hist:g4,seg4,i8,pl",
                                pad_policy="bucket", sync=sync)
    run = (lambda: tpipe.process_1(tm, [convert.events(e) for e in events],
                                   [convert.trajectory(t, "cpu") for t in trajs], 0.5,
                                   stereo_fusion=2, vopts=vopts))
    if sync:
        with pytest.raises(ValueError, match=r"int8=True needs weights in \[0, 1\]"):
            run()
        return
    res = run()
    with pytest.raises(ValueError, match=r"int8=True needs weights in \[0, 1\]"):
        tmapper.get_depth_map(tm[0], res.fused_dsi, tex.DepthMapOptions())
    tmapper.get_depth_map(tm[0], res.fused_dsi, tex.DepthMapOptions())  # read, cleared


# ---------------------------------------------------------------------------
# The reference view, decided on the host
# ---------------------------------------------------------------------------


def _edge_times(ts):
    """ts[0] and ts[-1], one float32 ulp either side, and a float64 a
    quarter ulp below each (which rounds onto it in float32)."""
    out = []
    for v in (ts[0], ts[-1]):
        v = np.float32(v)
        ulp = float(np.spacing(v))
        out += [float(v), float(np.nextafter(v, np.float32(-np.inf))),
                float(np.nextafter(v, np.float32(np.inf))), float(v) - ulp / 4]
    return out


@pytest.mark.parametrize("built", ["from_arrays", "slice_time", "convert"])
def test_reference_view_raises_where_pose_at_is_invalid(built):
    """`place_reference_view` raises at exactly the times `pose_at` calls
    invalid, with the trajectory's span on the host or (a trajectory built
    from JAX state) read once from the device."""
    rng = np.random.default_rng(9)
    ts = np.sort(rng.uniform(0.1, 0.9, 9)).astype(np.float32)
    q = np.tile([1.0, 0.0, 0.0, 0.0], (9, 1))
    p = rng.normal(size=(9, 3))
    traj = ttraj.from_arrays(ts, q, p, device="cpu")
    if built == "slice_time":
        traj = ttraj.slice_time(traj, float(ts[2]), float(ts[6]), pad=0)
        ts = ts[2:7]
    elif built == "convert":
        traj = ttraj.Trajectory(traj.ts, traj.poses)
    assert (traj.span is None) == (built == "convert")
    for t in _edge_times(ts):
        valid = bool(ttraj.pose_at(traj, t)[1])
        assert ttraj.valid_at(traj, t) == valid, t
        if valid:
            tpipe.place_reference_view(traj, t)
        else:
            with pytest.raises(ValueError, match="outside trajectory"):
                tpipe.place_reference_view(traj, t)


# ---------------------------------------------------------------------------
# Program keys and the program cache (plain Python)
# ---------------------------------------------------------------------------


def test_full_seq_keys_per_camera_and_bucket():
    """A full_seq run of 9 chunks gives at most 2 x (buckets seen) keys,
    and the two cameras (one mapper, two trajectories) never share one."""
    cpu = torch.device("cpu")
    mappers, events, trajs, _ = chip_smoke.build_workload(
        cpu, n_events=32768, width=96, height=64, dim_z=20, n_pts=2000)
    t_lo = min(float(e.t[0]) for e in events)
    t_hi = max(float(e.t[-1]) for e in events)
    fopts = tpipe.FullSeqOptions(start_time=t_lo, stop_time=t_hi, duration=0.2 * (t_hi - t_lo),
                                 out_skip=0.1 * (t_hi - t_lo))
    keys, buckets = [set(), set()], set()
    windows = list(tpipe.full_seq_windows(fopts))
    assert len(windows) == 9
    for t0, t1, _ in windows:
        for c in range(2):
            n = events[c].time_window(t0, t1).num
            buckets.add(tmapper.bucket_capacity(n, chip_smoke.PACKET))
            keys[c].add(tmapper.program_key(mappers[c], n, trajs[c], chip_smoke.PACKET,
                                            "hist:g4,seg4,bf,pl", 8, "device", "bucket"))
    assert not keys[0] & keys[1]
    assert len(keys[0] | keys[1]) <= 2 * len(buckets)
    assert all(len(k) == len(buckets) for k in keys)


def test_keys_follow_the_static_arguments(graft):
    mappers, events, trajs, _, packet_size = graft
    m, tr = convert.mapper(mappers[0]), convert.trajectory(trajs[0], "cpu")
    base = dict(packet_size=packet_size, backend="hist:g4,seg4,bf,pl", plane_block=8,
                rectify="device", pad="bucket")
    key = tmapper.program_key(m, 3000, tr, **base)
    assert key == tmapper.program_key(m, 4000, tr, **base)       # one bucket
    assert key != tmapper.program_key(m, 4200, tr, **base)       # the next
    for change in (dict(backend="scatter"), dict(plane_block=4), dict(rectify="lut"),
                   dict(pad="none"), dict(packet_size=256)):
        assert key != tmapper.program_key(m, 3000, tr, **{**base, **change}), change
    assert tmapper.program_key(m, 3000, tr, **{**base, "pad": "none"}) != \
        tmapper.program_key(m, 3001, tr, **{**base, "pad": "none"})


def test_program_cache_evicts_least_recently_used():
    closed = []

    class Fake:
        def __init__(self, name):
            self.name = name

        def close(self):
            closed.append(self.name)

    cache = tmapper.ProgramCache(3)
    for name in "abc":
        cache.put(name, Fake(name))
    assert cache.get("a").name == "a"              # a is now the most recent
    cache.put("d", Fake("d"))
    assert closed == ["b"] and cache.keys() == ["c", "a", "d"]
    cache.get("c")
    cache.put("e", Fake("e"))
    assert closed == ["b", "a"] and cache.keys() == ["d", "c", "e"]
    assert cache.get("b") is None
    cache.clear()
    assert closed == ["b", "a", "d", "c", "e"] and len(cache) == 0


def test_the_cache_holds_a_run_of_two_cameras():
    """PROGRAM_CACHE_SIZE holds two cameras times the buckets of process_1
    (the headline chunk), process_2/5 (its 4 sub-intervals) and full_seq
    (chunks of 0.2 of 4 Mi events either side of a bucket edge)."""
    P = chip_smoke.PACKET
    sizes = [chip_smoke.N_EVENTS, chip_smoke.N_EVENTS // chip_smoke.N_INTERVALS,
             int(0.19 * chip_smoke.FULL_SEQ_EVENTS), int(0.21 * chip_smoke.FULL_SEQ_EVENTS)]
    buckets = {tmapper.bucket_capacity(n, P) for n in sizes}
    assert tmapper.PROGRAM_CACHE_SIZE >= 2 * len(buckets)


def test_cpu_runs_the_body_eagerly(graft):
    """On the CPU no program is made, inside `eager()` or not, and both
    give the same DSI."""
    mappers, events, trajs, T_rv_w, packet_size = graft
    args = (convert.mapper(mappers[0]), convert.events(events[0]),
            convert.trajectory(trajs[0], "cpu"), convert.se3(T_rv_w, "cpu"))
    kw = dict(packet_size=packet_size, backend="hist:g4,seg4,bf,pl", pad="bucket")
    n = len(tmapper.programs())
    a = tmapper.evaluate_dsi(*args, **kw)
    with tmapper.eager():
        b = tmapper.evaluate_dsi(*args, **kw)
    tmapper.check_faults()
    assert torch.equal(a, b) and len(tmapper.programs()) == n


def test_jax_bucket_matches(graft):
    _, events, _, _, packet_size = graft
    for n in CHUNKS:
        assert tmapper.bucket_capacity(n, packet_size) == jmapper.bucket_capacity(n, packet_size)
    assert jvoting.DEFAULT_PACKET_SIZE == tvoting.DEFAULT_PACKET_SIZE
