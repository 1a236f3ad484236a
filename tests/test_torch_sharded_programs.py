"""The sharded step's programs (`parallel.sharded`, the counterpart of the
JAX package's jit of `make_sharded_step` and `make_sharded_voting_step`) on
the CPU, at the rig of tests/_torch_sharded.py and world size 1 over gloo:
segment bodies that make no host read, the segment plan and its skipped
collectives, the fault checks, the `_pad2d` cache, the program keys, the
shared `eager()`, and the CLI feed's tables.

On the CPU every step runs eagerly (no CUDA graph); the capture and the
replay are checked on the card by `chip_smoke.py` phase 10.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_sharded as S
from test_torch_programs import HostRead, _refuse_host_reads, chip_smoke

from dvs_mcemvs_tpu.ops import trajectory as jtraj
from dvs_mcemvs_tpu.ops.se3 import SE3 as JSE3
from dvs_mcemvs_tpu.parallel import sharded as jsharded
from dvs_mcemvs_torch import cli, config, convert, graphs, mapper as tmapper, pipeline as tpipe
from dvs_mcemvs_torch.kernels import binning
from dvs_mcemvs_torch.ops import extract as tex, grid as tgrid, trajectory as ttraj
from dvs_mcemvs_torch.ops.se3 import SE3
from dvs_mcemvs_torch.parallel import mesh as tmesh, sharded as tsharded

PACKET = S.PACKET
# The body's specs: the exact scatter, the hist specs of the parity tests,
# int8 binning, and `__graft_entry__.dryrun_multichip`'s spec.
SPECS = ["scatter", "hist:g4,ss2,seg4,bf,pl", "hist:g4,seg4,i8,pl", "hist:g2,ss2,seg4,bf,pl"]
KINDS = [tsharded.FULL, tsharded.VOTING]
# Meshes and this rank's coordinate on them: the event block or the plane
# block it computes.  Mesh (1, 1)'s one segment runs the ops of (2, 1)'s
# three in one, with every event.
MESH_RANKS = {(2, 1): (1, 0), (1, 2): (0, 1)}


@pytest.fixture(scope="module")
def both():
    """The JAX package's rig and the port's copy of it."""
    return S.build_rig()


@pytest.fixture(scope="module")
def rig(both):
    return both[1]


@pytest.fixture(scope="module")
def mesh():
    """The (1, 1) mesh of a one-rank gloo group on the CPU."""
    tmesh.init_distributed(f"127.0.0.1:{tmesh.free_port()}", 1, 0, "cpu")
    try:
        yield tmesh.make_mesh(1, 1, device="cpu")
    finally:
        tmesh.shutdown_distributed()


def _cfg(backend):
    return tsharded.ShardedStepConfig(fusion_method=2, packet_size=PACKET, backend=backend)


def _args(rig, n_event=1, ei=0):
    """The step's arguments of event block `ei` of `n_event`."""
    args = tsharded.sharded_step_inputs(rig["mappers"], rig["shard"], rig["trajs"],
                                        rig["T_rv_w"], n_event, PACKET)
    e_local = args[0].shape[1] // n_event
    return tuple(a[:, ei * e_local:(ei + 1) * e_local] for a in args[:4]) + tuple(args[4:])


def _fake_collective(op, state):
    """A collective as this test's one rank stands in for every rank of its
    group: an all-reduce leaves its block, an all-gather gives every block
    the rank's own."""
    if op.name == "all_gather":
        for key in ("conf", "idx"):
            for out in state[key + "s"]:
                out.copy_(state[key])


@contextlib.contextmanager
def _refused(monkeypatch):
    """`_refuse_host_reads`, and item assignment of a host value (a copy
    from the host that a capture refuses too)."""
    real = torch.Tensor.__setitem__

    def setitem(self, index, value):
        if not isinstance(value, torch.Tensor):
            raise HostRead("Tensor.__setitem__ of host data")
        return real(self, index, value)

    with monkeypatch.context() as m:
        _refuse_host_reads(m)
        m.setattr(torch.Tensor, "__setitem__", setitem)
        yield


def _run_segments(segments, args, guard=None):
    """The segments in order on the CPU, each compute segment under deferred
    weight checks (and inside `guard()`), `_fake_collective` between."""
    state = {"args": [torch.as_tensor(a) for a in args]}
    flag = binning.fault_flag("cpu")
    for seg in segments:
        if isinstance(seg, list):
            with binning.deferred_weight_checks(flag), (guard or contextlib.nullcontext)():
                tsharded._run_ops(seg, state)
        else:
            _fake_collective(seg, state)
    assert not flag.any()
    out = state["out"]
    return out if isinstance(out, dict) else {"dsi": out}


@pytest.mark.parametrize("shape", list(MESH_RANKS), ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend", SPECS)
def test_segment_bodies_make_no_host_read(rig, monkeypatch, backend, kind, shape):
    """Every compute segment of the step runs to its end with every host
    read refused, and computes what it computes without the refusal.  The
    first, unrefused run builds the tables a body fetches (kernel B's, the
    extraction's padding), as a program's eager warm-up does."""
    ei, pi = MESH_RANKS[shape]
    segments = tsharded._segments(tsharded._ops(
        tsharded.rig_spec_from_mappers(rig["mappers"]), _cfg(backend), kind, shape, pi))
    args = _args(rig, shape[0], ei)
    want = _run_segments(segments, args)
    got = _run_segments(segments, args, lambda: _refused(monkeypatch))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert float(want["dsi"].sum()) > 0


def test_the_guard_refuses_a_host_read_in_a_segment(rig, monkeypatch):
    """The guard above does reach a segment's body."""
    segments = tsharded._segments(tsharded._ops(
        tsharded.rig_spec_from_mappers(rig["mappers"]), _cfg("scatter"), tsharded.FULL,
        (1, 1), 0))
    for host_op in (lambda d: d[0] * float(d[1].sum()), lambda d: d[0].__setitem__(0, 1.0)):
        with monkeypatch.context() as m:
            m.setattr(tgrid, "fuse_many", lambda dsis, method: host_op(dsis) or dsis[0])
            with pytest.raises(HostRead):
                _run_segments(segments, _args(rig), lambda: _refused(monkeypatch))


# ---------------------------------------------------------------------------
# The segment plan: cut at the collectives that run
# ---------------------------------------------------------------------------


BODY = ["prepare", "camera0"]
PLANS = {
    (tsharded.FULL, (1, 1)): [BODY + ["camera1", "fuse+collapse", "decide+extract"]],
    (tsharded.FULL, (2, 1)): [BODY, "all_reduce camera0", ["camera1"], "all_reduce camera1",
                              ["fuse+collapse", "decide+extract"]],
    (tsharded.FULL, (1, 2)): [BODY + ["camera1", "fuse+collapse"], "all_gather",
                              ["decide+extract"]],
    (tsharded.FULL, (2, 2)): [BODY, "all_reduce camera0", ["camera1"], "all_reduce camera1",
                              ["fuse+collapse"], "all_gather", ["decide+extract"]],
    (tsharded.VOTING, (1, 1)): [BODY + ["camera1"]],
    (tsharded.VOTING, (2, 1)): [BODY, "all_reduce camera0", ["camera1"], "all_reduce camera1"],
    (tsharded.VOTING, (1, 2)): [BODY + ["camera1"]],
    (tsharded.VOTING, (2, 2)): [BODY, "all_reduce camera0", ["camera1"], "all_reduce camera1"],
}


@pytest.mark.parametrize("kind,shape", list(PLANS), ids=[f"{k}-{s[0]}x{s[1]}" for k, s in PLANS])
def test_segment_plan_cuts_at_the_collectives_that_run(rig, kind, shape):
    """Mesh (1, 1) is one segment; (2, 1) camera 0, all-reduce, camera 1,
    all-reduce, the rest; (1, 2) cuts at the plane all-gather; a collective
    over a group of one rank is left out."""
    spec = tsharded.rig_spec_from_mappers(rig["mappers"])
    for pi in range(shape[1]):
        assert tsharded.segment_plan(spec, _cfg("hist:g4,ss2,seg4,bf,pl"), kind, shape,
                                     pi) == PLANS[kind, shape]


def _parent_step(mesh, spec, cfg, args, kind):
    """The parent's eager step (every collective run, over groups of one
    rank here), the oracle of the skipped collectives."""
    dev = torch.device("cpu")
    (x, y, t, w, traj_ts, traj_q, traj_t, rv_q, rv_t, lut, K_cam, Kv_inv,
     depths) = (torch.as_tensor(a, device=dev) for a in args)
    splat = tsharded.voting.resolve_backend(cfg.backend)
    kw = {}
    if cfg.backend.startswith("hist"):
        u_full = 1.0 / depths
        kw["corr_u_mid"] = 0.5 * (torch.min(u_full) + torch.max(u_full))
        if kind == tsharded.FULL:
            kw["weights_binary"] = True
    dsis = []
    for c in range(spec.n_cameras):
        traj = ttraj.Trajectory(traj_ts[c], SE3(traj_q[c], traj_t[c]))
        packets = tsharded.voting.warp_events_to_z0(
            x[c], y[c], t[c], traj, SE3(rv_q, rv_t), lut[c], K_cam[c], Kv_inv, z0=spec.z0,
            width=spec.width, packet_size=cfg.packet_size, ev_weight=w[c], full=True)
        dsi_c = splat(packets, depths, spec.z0, spec.vcam_params, spec.width, spec.height,
                      plane_block=cfg.plane_block, **kw)
        dist.all_reduce(dsi_c, group=mesh.get_group("event"))
        dsis.append(dsi_c)
    if kind == tsharded.VOTING:
        return {"dsi": torch.stack(dsis)}
    fused = tgrid.fuse_many(dsis, cfg.fusion_method)
    conf_l, idx_l = tgrid.collapse(fused, cfg.extract_options.collapse_method)
    idx_l = idx_l.to(torch.int32)
    confs, idxs = [torch.empty_like(conf_l)], [torch.empty_like(idx_l)]
    dist.all_gather(confs, conf_l.contiguous(), group=mesh.get_group("plane"))
    dist.all_gather(idxs, idx_l.contiguous(), group=mesh.get_group("plane"))
    confs, idxs = torch.stack(confs), torch.stack(idxs)
    best = torch.argmax(confs, dim=0)[None]
    conf = torch.take_along_dim(confs, best, dim=0)[0]
    idx = torch.take_along_dim(idxs, best, dim=0)[0]
    res = tex.extract_from_collapsed(conf, idx, spec.depth_vec, cfg.extract_options)
    return {"dsi": fused, "depth": res.depth, "confidence": res.confidence,
            "mask": res.mask, "depth_indices": res.depth_indices}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend", ["scatter", "hist:g4,ss2,seg4,bf,pl"])
def test_skipped_collectives_give_the_parent_step_bit_for_bit(rig, mesh, backend, kind):
    spec = tsharded.rig_spec_from_mappers(rig["mappers"])
    make = tsharded.make_sharded_step if kind == tsharded.FULL else \
        tsharded.make_sharded_voting_step
    n = len(tsharded.programs())
    got = make(mesh, spec, _cfg(backend))(*_args(rig))
    want = _parent_step(mesh, spec, _cfg(backend), _args(rig), kind)
    tmapper.check_faults()
    got = got if isinstance(got, dict) else {"dsi": got}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert len(tsharded.programs()) == n       # the CPU runs no program


# ---------------------------------------------------------------------------
# Refused weights raise at the step's fault check
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,bad,message", [
    ("hist:g4,seg4,bf,pl", 0.5, "not all 0 or 1"),
    ("hist:g4,seg4,i8,pl", 1.5, "not all 0 or 1"),
    ("hist:g4,seg4,i8,pl", float("nan"), "not all 0 or 1")])
def test_refused_weights_raise_at_the_step_check(rig, mesh, backend, bad, message):
    """The full step passes its weights as binary: a weight outside {0, 1}
    raises at the step's one read of the fault flag, so no depth map comes
    back; the read clears the flag, and the next clean step runs."""
    step = tsharded.make_sharded_step(mesh, tsharded.rig_spec_from_mappers(rig["mappers"]),
                                      _cfg(backend))
    args = [np.array(a) for a in _args(rig)]
    args[3][1, 7] = bad
    with pytest.raises(ValueError, match=message):
        step(*args)
    out = step(*_args(rig))
    assert torch.isfinite(out["depth"]).all()


@pytest.mark.parametrize("bad", [1.5, float("nan")], ids=["over", "nan"])
def test_refused_int8_weights_through_the_pair_never_become_a_depth_map(rig, mesh, bad):
    """process_2 voting each sub-interval on the sharded voting step (the
    CLI's mesh `evaluate_pair`): int8 binning refuses a weight outside
    [0, 1] at the pipeline's read after the pair."""
    vstep = tsharded.make_sharded_voting_step(
        mesh, tsharded.rig_spec_from_mappers(rig["mappers"]), _cfg("hist:g4,seg4,i8,pl"))

    def evaluate_pair(mps, evs, trs, T_rv_w):
        args = [np.array(a) for a in tsharded.sharded_step_inputs(mps, evs, trs, T_rv_w, 1,
                                                                  PACKET)]
        args[3][0, 5] = bad
        out = vstep(*args)
        return out[0], out[1]

    with pytest.raises(ValueError, match=r"int8=True needs weights in \[0, 1\]"):
        tpipe.process_2(rig["mappers"], rig["shard"], rig["trajs"], 0.5, stereo_fusion=2,
                        temporal_fusion=2, num_intervals=2, evaluate_pair=evaluate_pair)
    tmapper.check_faults()                      # read, cleared


# ---------------------------------------------------------------------------
# The extraction: padding tables cached, no host read
# ---------------------------------------------------------------------------


def _parent_pad2d(img, ph, pw, border):
    """The parent's `_pad2d`, which uploaded its index arrays at each call."""
    H, W = img.shape[-2:]
    out = img
    for dim, n, (b, a) in ((-2, H, ph), (-1, W, pw)):
        idx = tgrid._pad_index(n, b, a, border)
        out = torch.index_select(out, dim, torch.as_tensor(np.maximum(idx, 0)))
        if (idx < 0).any():
            shape = [1] * out.ndim
            shape[dim] = -1
            out = out * torch.as_tensor(idx >= 0).reshape(shape).to(out.dtype)
    return out


@pytest.mark.parametrize("border", ["replicate", "reflect", "reflect101", "zero"])
def test_pad2d_cache_equals_the_uncached_padding(monkeypatch, border):
    rng = np.random.default_rng(4)
    for shape, ph, pw in (((13, 17), (2, 2), (1, 3)), ((3, 9, 5), (0, 4), (2, 0)),
                          ((1, 1), (1, 1), (2, 2))):
        img = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)
        want = _parent_pad2d(img, ph, pw, border)
        assert torch.equal(tgrid._pad2d(img, ph, pw, border), want)
        n = len(tgrid._PAD_TABLES)
        with _refused(monkeypatch):
            assert torch.equal(tgrid._pad2d(img, ph, pw, border), want)
        assert len(tgrid._PAD_TABLES) == n


@pytest.mark.parametrize("levels", [16, 300])
def test_extraction_makes_no_host_read(monkeypatch, levels):
    """`extract_from_collapsed`, the rank-search median (up to 256 planes)
    and the sort one, under the host-read guard after one unguarded run."""
    rng = np.random.default_rng(6)
    conf = torch.as_tensor(rng.gamma(2.0, 3.0, (40, 56)), dtype=torch.float32)
    idx = torch.as_tensor(rng.integers(0, levels, (40, 56)), dtype=torch.int32)
    dv = tex.DepthVector("linear", 1.0, 4.0, levels)
    opts = tex.DepthMapOptions(max_confidence=40.0)
    want = tex.extract_from_collapsed(conf, idx, dv, opts)
    with _refused(monkeypatch):
        got = tex.extract_from_collapsed(conf, idx, dv, opts)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


# ---------------------------------------------------------------------------
# Program keys, the shared eager(), the CLI feed's tables
# ---------------------------------------------------------------------------


def test_program_keys_follow_what_fixes_the_program(rig):
    spec = tsharded.rig_spec_from_mappers(rig["mappers"])
    cfg = _cfg("hist:g4,seg4,bf,pl")
    base = dict(device="cpu", mesh_shape=(2, 1), coordinate=[0, 0], backend="gloo",
                spec=spec, cfg=cfg, kind=tsharded.FULL, args=_args(rig, 2))
    key = tsharded.step_key(**base)
    other = [np.array(a) for a in _args(rig, 2)]
    other[0][:] = 0
    assert key == tsharded.step_key(**{**base, "args": other})      # other events
    assert key == tsharded.step_key(**{**base, "coordinate": (0, 0)})
    bigger = tsharded.sharded_step_inputs(rig["mappers"], rig["shard"], rig["trajs"],
                                          rig["T_rv_w"], 2, PACKET, capacity=2 ** 15)
    for change in (dict(mesh_shape=(1, 2)), dict(coordinate=(1, 0)), dict(backend="nccl"),
                   dict(spec=tsharded.dataclasses.replace(spec, z0=spec.z0 + 1)),
                   dict(cfg=_cfg("hist:g4,seg4,i8,pl")),
                   dict(cfg=tsharded.dataclasses.replace(cfg, fusion_method=4)),
                   dict(kind=tsharded.VOTING), dict(args=bigger), dict(device="cuda:0"),
                   dict(args=_args(rig, 2)[:4] + tuple(
                       np.asarray(a, np.float64) for a in _args(rig, 2)[4:]))):
        assert key != tsharded.step_key(**{**base, **change}), change


def test_eager_turns_off_every_program():
    """One `eager()` for the chunk programs and the sharded ones."""
    assert tmapper.eager is graphs.eager and tmapper.ProgramCache is graphs.ProgramCache
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert graphs.use_programs(cuda) and not graphs.use_programs(cpu)
    with tmapper.eager():
        assert not graphs.use_programs(cuda)
        with graphs.eager():
            assert not graphs.use_programs(cuda)
        assert not graphs.use_programs(cuda)
    assert graphs.use_programs(cuda)


def test_device_tables_equal_the_host_tables(both):
    """`device_step_tables` with the placement, and `replicated_step_tables`
    built on it, give the JAX package's `replicated_step_tables` arrays
    exactly, a shorter trajectory padded by its last pose."""
    j, t = both
    jtr = j["trajs"][1]
    jshort = jtraj.Trajectory(jtr.ts[:-3], JSE3(jtr.poses.q[:-3], jtr.poses.t[:-3]))
    for jtrajs in (j["trajs"], [j["trajs"][0], jshort]):
        trajs = [convert.trajectory(tr, "cpu") for tr in jtrajs]
        want = jsharded.replicated_step_tables(j["mappers"], jtrajs, j["T_rv_w"])
        got = tsharded.with_placement(
            tsharded.device_step_tables(t["mappers"], trajs, "cpu"), t["T_rv_w"])
        host = tsharded.replicated_step_tables(t["mappers"], trajs, t["T_rv_w"])
        assert len(got) == len(host) == len(want) == 9
        for g, h, w in zip(got, host, want):
            w = np.asarray(w)
            assert g.dtype == torch.float32 and h.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g.numpy(), w)
            np.testing.assert_array_equal(h, w)


@pytest.mark.parametrize("per_process", [False, True], ids=["shards", "slices"])
def test_mesh_feed_builds_the_tables_once(rig, mesh, monkeypatch, per_process):
    """The CLI's mesh runner builds the step's tables once, where it is
    made, and each chunk's feed gives the arguments of
    `sharded_step_inputs` cut to the rank's block, under `--num_devices`
    (shards of the chunk) and a multi-process launch (each rank's slice)."""
    built, fed = [], []
    real = tsharded.device_step_tables
    monkeypatch.setattr(tsharded, "device_step_tables",
                        lambda *a: built.append(1) or real(*a))
    cfg = config.RunConfig(dimZ=16, packet_size=PACKET, splat_backend="scatter")
    feed = cli._MeshFeed(cfg, "scatter", torch.device("cpu"), cli.Ranks(0, 1, per_process))
    real_inputs = feed.inputs
    monkeypatch.setattr(feed, "inputs", lambda *a: fed.append(real_inputs(*a)) or fed[-1])
    run_mesh = cli._make_mesh_runner(cfg, rig["mappers"], rig["trajs"],
                                     tex.DepthMapOptions(), "scatter", feed)
    for _ in range(2):
        res = run_mesh(rig["mappers"], rig["shard"], rig["trajs"], 0.5, sync=False)
        assert torch.isfinite(res.extracted.depth).all()
    tmapper.check_faults()
    assert len(built) == 1 and len(fed) == 2
    cap = tmapper.bucket_capacity(max(e.num for e in rig["shard"]), PACKET)
    T_rv_w = tpipe.place_reference_view(rig["trajs"][0], 0.5)
    want = tsharded.sharded_step_inputs(rig["mappers"], rig["shard"], rig["trajs"],
                                        T_rv_w, 1, PACKET, capacity=cap)
    for args, n_ev in fed:
        assert len(args) == len(want) == 13
        for g, w in zip(args, want):
            np.testing.assert_array_equal(np.asarray(g), w)
        assert n_ev == sum(e.num for e in rig["shard"])


def test_the_step_cache_holds_both_steps_of_a_run():
    """STEP_PROGRAM_CACHE_SIZE holds the full and the voting step times the
    buckets of a run on any event axis (a program holds every camera):
    process_1's chunk, process_2/5's sub-intervals and full_seq windows on
    both sides of a bucket edge, as the chunk programs' cache counts them."""
    P = chip_smoke.PACKET
    sizes = [chip_smoke.N_EVENTS, chip_smoke.N_EVENTS // chip_smoke.N_INTERVALS,
             int(0.19 * chip_smoke.FULL_SEQ_EVENTS), int(0.21 * chip_smoke.FULL_SEQ_EVENTS)]
    for n_event in (1, 2, 4):
        buckets = {tmapper.bucket_capacity(n, n_event * P) for n in sizes}
        assert tsharded.STEP_PROGRAM_CACHE_SIZE >= 2 * len(buckets), n_event
