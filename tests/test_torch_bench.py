"""bench_torch.py, the port's benchmark, against bench.py on the CPU.

Both modules are cut to the same small size (128x96x16, 16,384 events a
step, 32,768 a sustained chunk, 512-event packets) and hold: the same
workload (events equal to the bit); the voting step's DSI, the full and
alg2 chunks' depth maps and every decoded buffer of the sustained loop
within the port's CPU parity tolerances; the quantized pack and its
decoding to bench.py's lines; every step's body with no host read.  The
JAX side runs `hist:g4,seg4` on its XLA engine and `hist:g4,seg4,bf,pl`
in Pallas interpret mode, as its own tests run them; the port runs the
kernels' plain versions.  On the CPU the steps run eagerly; their programs
are checked against `mapper.eager()` on the card by chip_smoke.py phase 14.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_util import to_np
from test_torch_programs import _refuse_host_reads

from dvs_mcemvs_tpu.utils import writers as jwriters
from dvs_mcemvs_torch.kernels import binning

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = dict(WIDTH=128, HEIGHT=96, DIM_Z=16, N_EVENTS=16384, PACKET=512)
SUSTAINED_EVENTS = 32768
SPEC, PL_SPEC = "hist:g4,seg4", "hist:g4,seg4,bf,pl"
PLANE_BLOCK = 8
# The port's CPU parity tolerances: a hist DSI within relative L1 1e-2 and
# vote mass 1e-3 (bf16 roundings flipped by f32 summation order); depth
# maps equal in their plane index on >= 99.9 % of the pixels, and within
# 1e-5 relative where the indices agree (tests/test_torch_chunk_programs.py).
DSI_L1, MASS_REL = 1e-2, 1e-3
EQUAL_SHARE, DEPTH_REL = 0.999, 1e-5
SCALE_REL = 1e-5
# The keys of bench.py's sustained report that the port renames or drops,
# and those it adds.
SUSTAINED_RENAMED = {"hbm_resident_events": "device_resident_events"}
SUSTAINED_DROPPED = {"note"}
SUSTAINED_ADDED = {"final_drain_s", "save_s_per_chunk"}


def _load(file, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, file))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def benches():
    """(bench.py, bench_torch.py), each loaded afresh and cut to SIZE."""
    mp = pytest.MonkeyPatch()
    mods = (_load("bench.py", "_bench_jax"), _load("bench_torch.py", "_bench_torch"))
    for mod in mods:
        for k, v in SIZE.items():
            mp.setattr(mod, k, v)
    yield mods
    mp.undo()


@pytest.fixture(scope="module")
def workloads(benches):
    jb, tb = benches
    return jb.build_workload(), tb.build_workload("cpu")


def _jax_args(x, y, t):
    return jnp.asarray(x, jnp.int32), jnp.asarray(y, jnp.int32), jnp.asarray(t, jnp.float32)


def test_build_workload(workloads):
    """(a) The same events to the bit; the trajectory and the reference
    view within 1e-6; the same mapper."""
    (jm, jev, jtraj, jT), (tm, tev, ttraj, tT) = workloads
    for a, b in zip(jev, tev):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(jtraj.ts), to_np(ttraj.ts))
    for a, b in ((jtraj.poses.q, ttraj.poses.q), (jtraj.poses.t, ttraj.poses.t),
                 (jT.q, tT.q), (jT.t, tT.t)):
        np.testing.assert_allclose(to_np(b), np.asarray(a), rtol=0, atol=1e-6)
    assert tm.dsi_shape == jm.dsi_shape
    np.testing.assert_array_equal(tm.vcam.P, jm.vcam.P)
    np.testing.assert_array_equal(tm.depth_vec.depths(), jm.depth_vec.depths())


@pytest.mark.parametrize("spec", [SPEC, PL_SPEC])
def test_make_step(benches, workloads, spec):
    """(b) One camera's warp and vote: the DSI within relative L1 1e-2, its
    vote mass within 1e-3."""
    jb, tb = benches
    (jm, ev, jtraj, jT), (tm, _, ttraj, tT) = workloads
    want = np.asarray(jb.make_step(jm, jtraj, jT, spec, PLANE_BLOCK)(*_jax_args(*ev)),
                      np.float64)
    got = to_np(tb.make_step(tm, ttraj, tT, spec, PLANE_BLOCK)(
        *tb.device_args(*ev, "cpu"))).astype(np.float64)
    assert got.shape == want.shape == (SIZE["DIM_Z"], SIZE["HEIGHT"], SIZE["WIDTH"])
    l1 = np.abs(got - want).sum() / np.abs(want).sum()
    assert l1 < DSI_L1, f"relative L1 {l1:.3g}"
    assert abs(got.sum() / want.sum() - 1) < MASS_REL


def _assert_same_depth(tm, got, want):
    """Plane indices (nearest plane of each depth) equal on EQUAL_SHARE of
    the pixels; where they are, the depths within DEPTH_REL."""
    assert got.shape == want.shape == (SIZE["HEIGHT"], SIZE["WIDTH"])
    assert np.isfinite(got).all() and (got > 0).sum() > 100
    idx = [to_np(tm.depth_vec.depth_to_cell_index(torch.from_numpy(np.array(d))))
           for d in (got, want)]
    same = idx[0] == idx[1]
    assert same.mean() >= EQUAL_SHARE, f"indices equal on {same.mean():.5f}"
    rel = np.abs(got[same] - want[same]) / want[same]
    assert rel.max() <= DEPTH_REL, f"depth relative error {rel.max():.3g}"


@pytest.mark.parametrize("maker", ["make_full_chunk_step", "make_alg2_step"])
def test_two_camera_steps(benches, workloads, maker):
    """(c) the full chunk and (d) alg2: both cameras, HM fusion, extraction;
    the depth maps agree (`_assert_same_depth`)."""
    jb, tb = benches
    (jm, ev, jtraj, jT), (tm, _, ttraj, tT) = workloads
    want = np.asarray(getattr(jb, maker)(jm, jtraj, jT, SPEC, PLANE_BLOCK)(*_jax_args(*ev)))
    got = to_np(getattr(tb, maker)(tm, ttraj, tT, SPEC, PLANE_BLOCK)(
        *tb.device_args(*ev, "cpu")))
    _assert_same_depth(tm, got, want)


class _RecordingPool:
    """A SaveWorkerPool that records each submitted save's arguments and
    runs it at once."""

    def __init__(self, calls):
        self.calls = calls

    def submit(self, fn, *args):
        self.calls.append(args)
        fn(*args)

    def drain(self):
        pass

    def shutdown(self):
        pass


def _quantized(arr, H, W):
    """The downlinked planes as (u16 depth, u8 confidence, u8 mask) and the
    confidence's f32 [min, max]."""
    pl4 = arr[:-8].reshape(4, H, W).astype(np.int64)
    return pl4[0] << 8 | pl4[1], pl4[2], pl4[3], arr[-8:].view(np.float32)


def test_full_seq_sustained(benches, monkeypatch):
    """(e) Four chunks, one not timed: the same report keys (less those
    renamed, dropped and added above) and counts, and every chunk's
    downlinked buffer against bench.py's (recorded from its save pool):
    masks equal, depth within one u16 step and confidence within one u8
    step on >= 99.9 % of the pixels, the confidence range within 1e-5."""
    jb, tb = benches
    for mod in benches:
        monkeypatch.setattr(mod, "N_EVENTS", SUSTAINED_EVENTS)
    calls = []
    monkeypatch.setattr(jwriters, "SaveWorkerPool", lambda *a, **k: _RecordingPool(calls))
    jrep = jb.full_seq_sustained(SPEC, plane_block=PLANE_BLOCK, n_chunks=4, warmup=1)
    got = {}
    trep = tb.full_seq_sustained(SPEC, plane_block=PLANE_BLOCK, n_chunks=4, warmup=1,
                                 device="cpu", buffers=got)
    keys = {SUSTAINED_RENAMED.get(k, k) for k in jrep} - SUSTAINED_DROPPED | SUSTAINED_ADDED
    assert set(trep) == keys
    for k in ("chunks_timed", "events_per_chunk", "artifact_files", "store_ingest"):
        assert trep[k] == jrep[k], k
    # (bench.py rounds its sizes and rates; the port does not.)
    assert round(trep["downlink_mb_per_chunk"], 2) == jrep["downlink_mb_per_chunk"]
    assert trep["chunks_timed"] == 3 and trep["events_per_chunk"] == 2 * SUSTAINED_EVENTS
    assert trep["artifact_files"] == 2 * 4 and trep["device_resident_events"]
    assert "saveDepthMaps" in trep["includes"] and trep["mev_s"] > 0
    want = {k: np.asarray(out) for k, _, out in calls}
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    H, W = SIZE["HEIGHT"], SIZE["WIDTH"]
    for k in want:
        assert got[k].dtype == want[k].dtype == np.uint8
        assert got[k].shape == want[k].shape == (4 * H * W + 8,)
        gd, gc, gm, gs = _quantized(got[k], H, W)
        wd, wc, wm, ws = _quantized(want[k], H, W)
        assert (gm == wm).mean() >= EQUAL_SHARE, k
        assert (np.abs(gd - wd) <= 1).mean() >= EQUAL_SHARE, k
        assert (np.abs(gc - wc) <= 1).mean() >= EQUAL_SHARE, k
        np.testing.assert_allclose(gs, ws, rtol=SCALE_REL)


def _bench_pack(depth, conf, mask, min_d, max_d):
    """bench.py:380-392's quantized pack, as its jitted step runs it."""
    import jax

    dq = jnp.clip((depth - min_d) / (max_d - min_d), 0, 1) * 65535
    dq = dq.astype(jnp.uint16)
    cmin, cmax = jnp.min(conf), jnp.max(conf)
    cq = ((conf - cmin) / jnp.maximum(cmax - cmin, 1e-9) * 255).astype(jnp.uint8)
    planes = jnp.stack([(dq >> 8).astype(jnp.uint8), (dq & 0xFF).astype(jnp.uint8), cq,
                        mask.astype(jnp.uint8)])
    scales = jnp.stack([cmin, cmax]).astype(jnp.float32)
    scales_u8 = jax.lax.bitcast_convert_type(scales, jnp.uint8)
    return np.asarray(jnp.concatenate([planes.reshape(-1), scales_u8.reshape(-1)]))


def _bench_unpack(arr, H, W, min_d, max_d):
    """bench.py:395-403's decoding of the downlinked bytes."""
    scales = arr[-8:].view(np.float32)
    pl4 = arr[:-8].reshape(4, H, W)
    depth = (pl4[0].astype(np.uint16) << 8 | pl4[1]).astype(np.float32)
    depth = depth / 65535.0 * (max_d - min_d) + min_d
    conf = pl4[2].astype(np.float32)
    conf = conf / 255.0 * (scales[1] - scales[0]) + scales[0]
    mask = pl4[3]
    return np.where(mask > 0, depth, 0.0), conf, mask


def test_pack_round_trip(benches):
    """(f) On hand-made maps (depths inside and outside [2, 40] m, a
    confidence range, a mask): the port's packed bytes equal bench.py's
    pack to the bit, its decoding equals bench.py's to the bit, and the
    round trip keeps the mask exactly, zero depth off it, the clipped depth
    within one u16 step and the confidence within one u8 step."""
    _, tb = benches
    rng = np.random.default_rng(15)
    H, W, lo, hi = 24, 40, 2.0, 40.0
    depth = rng.uniform(0.5, 45.0, (H, W)).astype(np.float32)
    depth[0, :4] = [lo, hi, 0.0, np.float32(np.nextafter(np.float32(hi), np.float32(0)))]
    conf = rng.uniform(3.0, 90.0, (H, W)).astype(np.float32)
    mask = (rng.random((H, W)) > 0.4).astype(np.uint8)
    packed = to_np(tb.pack_maps(torch.as_tensor(depth), torch.as_tensor(conf),
                                torch.as_tensor(mask), lo, hi))
    np.testing.assert_array_equal(packed, _bench_pack(depth, conf, mask, lo, hi))
    got = tb.unpack_maps(packed, H, W, lo, hi)
    for a, b in zip(got, _bench_unpack(packed, H, W, lo, hi)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    d, c, m = got
    np.testing.assert_array_equal(m, mask)
    assert (d[mask == 0] == 0).all()
    on = mask > 0
    clipped = np.clip(depth, lo, hi)
    assert np.abs(d[on] - clipped[on]).max() <= (hi - lo) / 65535 * (1 + 1e-3)
    assert np.abs(c - conf).max() <= (conf.max() - conf.min()) / 255 * (1 + 1e-3)


def _bodies(tb, workload, spec):
    """Each step's body with its inputs: (name, step, args)."""
    tm, ev, ttraj, tT = workload
    args = tb.device_args(*ev, "cpu")
    out = [(maker, getattr(tb, maker)(tm, ttraj, tT, spec, PLANE_BLOCK), args)
           for maker in ("make_step", "make_full_chunk_step", "make_alg2_step")]
    out.append(("make_sustained_step", tb.make_sustained_step(tm, ttraj, spec, PLANE_BLOCK),
                (*args, torch.tensor([0.5], dtype=torch.float32))))
    return out


@pytest.mark.parametrize("spec", [SPEC, PL_SPEC])
def test_bodies_make_no_host_read(benches, workloads, monkeypatch, spec):
    """(g) Every step's body (the voting step, the full and alg2 chunks,
    the sustained chunk with its pose and pack) runs to its end with every
    host read refused (tests/test_torch_programs.py's guard), and gives
    what it gives without the refusal, under deferred weight checks as a
    program runs it.  A first run builds the kernel-B tables from host
    arrays; the refused run reads them from the cache."""
    _, tb = benches
    flag = binning.fault_flag("cpu")
    for name, step, args in _bodies(tb, workloads[1], spec):
        with binning.deferred_weight_checks(flag):
            want = step.body(*args)
            with monkeypatch.context() as m:
                _refuse_host_reads(m)
                got = step.body(*args)
        assert torch.equal(got, want), name
    assert not flag.any()


def test_time_step_protocol(benches, workloads):
    """time_step on the CPU: it runs the step, sizes its regions (at least
    10 iterations) and returns a positive time; a step's call takes
    `fresh_out` on the CPU too."""
    _, tb = benches
    tm, ev, ttraj, tT = workloads[1]
    step = tb.make_step(tm, ttraj, tT, SPEC, PLANE_BLOCK)
    calls = []
    body = step.body
    step.body = lambda *a: (calls.append(1), body(*a))[1]
    dt = tb.time_step(step, tb.device_args(*ev, "cpu"), min_time=1e-3)
    assert dt > 0
    assert len(calls) == 1 + 1 + 3 * 10


# bench.py's `detail` keys (bench.py:623-642); the port's line has each.
BENCH_DETAIL_KEYS = {
    "backend", "backend_is_cli_auto_spec", "plane_block", "dsi", "events", "seconds_per_step",
    "full_chunk_mev_s", "full_chunk_vs_baseline", "full_chunk_events", "full_chunk_seconds",
    "alternatives_mev_s", "alg2_chunk_mev_s", "full_seq_sustained_mev_s",
    "full_seq_sustained", "golden", "mfu", "device"}


def _port_bench(monkeypatch, spec=None):
    """bench_torch as chip_smoke.py imports it, cut to SIZE; the golden
    gate (BENCH16 is too large for the CPU) replaced by a passing score of
    `spec`; a roofline report to pass in."""
    import sys

    sys.path.insert(0, REPO)
    import bench_torch

    for k, v in SIZE.items():
        monkeypatch.setattr(bench_torch, k, v)
    spec = spec or bench_torch.headline_spec()
    monkeypatch.setattr(bench_torch, "golden_gate",
                        lambda spec, device: {"spec": spec, "pass": True})
    roofline = {"peaks": {}, "stages": {"chunk": {"ms": 1.0, "bound_ms": 0.5}},
                "summary": {}, "spec": spec}
    return bench_torch, spec, roofline


def test_chip_smoke_bench_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py phase 14 at the small size on the CPU (no launch
    checks, one iteration a timed region, the golden gate and the roofline
    stubbed): each step against
    itself inside `mapper.eager()`, `bench_torch.run`'s stages and line in
    bench.py's shape (vs_baseline null, bench.py's detail keys), the
    sustained loop's counts, and its chunks' bytes against the same loop
    inside `mapper.eager()`."""
    import chip_smoke

    bt, spec, roofline = _port_bench(monkeypatch)
    monkeypatch.setattr(chip_smoke, "HEADLINE_SPEC", spec)
    timer = bt.time_step
    monkeypatch.setattr(bt, "time_step", lambda step, args, min_time: timer(
        step, args, iters=1, min_time=min_time))
    line = chip_smoke.bench_phase(torch.device("cpu"), roofline, min_time=1e-3, n_chunks=4,
                                  needed=())
    assert line["metric"] == "dsi_voting_throughput" and line["unit"] == "Mev/s"
    assert line["value"] > 0 and line["vs_baseline"] is None
    detail = line["detail"]
    assert BENCH_DETAIL_KEYS <= set(detail)
    assert detail["full_chunk_vs_baseline"] is None and detail["failed"] == []
    assert detail["full_seq_sustained"]["chunks_timed"] == 2
    assert detail["mfu"]["stages"]["chunk"] == {"ms": 1.0, "bound_ms": 0.5}
    assert set(detail["launches"]) == set(chip_smoke.BENCH_STAGES) | {"roofline"}


def test_failed_stage_is_recorded(monkeypatch):
    """A stage that raises is recorded in its entry and in `failed` (so
    main exits non-zero), the others still run; a golden gate that does not
    pass is a failed stage."""
    bt, spec, roofline = _port_bench(monkeypatch)

    def broken(*args, **kwargs):
        raise RuntimeError("alg2 broke")

    monkeypatch.setattr(bt, "make_alg2_step", broken)
    monkeypatch.setattr(bt, "time_step", lambda step, args, min_time: 0.5)
    monkeypatch.setattr(bt, "full_seq_sustained", lambda *a, **k: {"mev_s": 1.0})
    monkeypatch.setattr(bt, "golden_gate", lambda spec, device: {"spec": spec, "pass": False})
    line, failed = bt.run(torch.device("cpu"), n_chunks=4, roofline=roofline)
    assert failed == ["alg2", "golden"]
    assert line["detail"]["alg2_chunk_mev_s"] == {"error": "RuntimeError('alg2 broke')"}
    assert line["detail"]["full_chunk_seconds"] == 0.5 and line["value"] > 0
