"""Shared parts of the sharded-step parity tests (tests/test_torch_parallel.py,
test_torch_sharded_hist.py, test_torch_sharded_pl.py,
test_torch_sharded_pl_voting.py).

The fixture is `tests/test_parallel.py`'s esim-like rig (240x180, Z=16,
two cameras, ~11,000 events each).  The port's sharded step and sharded
voting step run on 4 gloo CPU ranks on meshes (4, 1), (1, 4) and (2, 2);
the JAX sharded step runs on the same mesh over 4 of the 8 virtual CPU
devices; the port's single-device voting of the same packets is the third
side.  Tolerances, by backend:

  - `scatter`: the port against JAX's sharded step within relative L1 1e-4,
    the port's tolerance for the exact backend between the packages (the
    warp's f32 operations differ by an ulp now and then,
    tests/test_torch_pipeline.py); against its own single device to the
    bit without event shards, and with them within 1e-5 (relative and
    absolute) with >= 99.9 % equal depth indices: the all-reduce adds the
    shards' partial grids in another order than one pass over the events,
    the tolerance tests/test_multihost.py gives the JAX package's psum
    reassociation;
  - `hist:g1,ss2` (exact grouping): within 1e-3 with equal depth indices,
    tests/test_parallel.py:128-153's tolerance;
  - `hist:g4,ss2,seg4,bf,pl`: tests/test_parallel.py:156-189's statistical
    gate against JAX's sharded step.  Against the port's single device the
    same gate, with its correlation and mass limits widened to the JAX
    package's own mesh-vs-one-device deviation on the same mesh: with event
    shards each shard groups its own packets (11 or 21 here, in groups of
    4 with weight-0 padding packets whose centers count), which moves the
    vote mass by 2.5 % on (4, 1) and 0.7 % on (2, 2) in the JAX package.
"""

import os

import jax.numpy as jnp
import numpy as np

from _torch_ranks import sharded_steps
from _torch_util import to_np

from dvs_mcemvs_tpu import pipeline as jpipe
from dvs_mcemvs_tpu.mapper import DsiShape, make_mapper
from dvs_mcemvs_tpu.ops import se3 as jse3, trajectory as jtraj
from dvs_mcemvs_tpu.ops.se3 import SE3 as JSE3
from dvs_mcemvs_tpu.parallel import mesh as jmesh, sharded as jsharded
from dvs_mcemvs_tpu.utils import synthetic
from dvs_mcemvs_torch import convert, mapper as tmapper
from dvs_mcemvs_torch.ops import grid as tgrid
from dvs_mcemvs_torch.parallel import sharded as tsharded
from dvs_mcemvs_torch.parallel.mesh import spawn_ranks

PACKET = 256
MESHES = [(4, 1), (1, 4), (2, 2)]
MESH_IDS = [f"{e}x{p}" for e, p in MESHES]
BACKENDS = {"scatter": "scatter", "g1ss2": "hist:g1,ss2", "pl": "hist:g4,ss2,seg4,bf,pl"}


def build_rig():
    """The JAX package's objects and the port's copies of them.  The
    single-device run drops the tail packet ((E-1)//P packets): it is fed
    n*P+1 events and the sharded step exactly n*P, so both vote the same
    packets."""
    r = synthetic.esim_like_rig()
    rng = np.random.default_rng(0)
    pts = synthetic.make_scene(r, rng, 1200)
    ev0 = synthetic.simulate_events(r, pts, 0, n_samples=12, rng=rng)
    ev1 = synthetic.simulate_events(r, pts, 1, n_samples=12, rng=rng)
    shape = DsiShape(dim_z=16, min_depth=1.0, max_depth=4.0)
    jm = [make_mapper(r.cam, shape), make_mapper(r.cam, shape)]
    ts, q, p = synthetic.rig_poses(r)
    traj0 = jtraj.from_arrays(ts, q, p)
    T_1_0 = JSE3(jnp.asarray([1.0, 0, 0, 0], jnp.float32),
                 jnp.asarray([-r.baseline, 0, 0], jnp.float32))
    jt = [traj0, jtraj.apply_right(traj0, jse3.inverse(T_1_0))]
    jT = jpipe.place_reference_view(traj0, 0.5)
    single, shard = [], []
    for ev in (ev0, ev1):
        n = (ev.num - 1) // PACKET
        single.append(ev.slice(0, n * PACKET + 1))
        shard.append(ev.slice(0, n * PACKET))
    port = dict(mappers=[convert.mapper(m) for m in jm],
                trajs=[convert.trajectory(t, "cpu") for t in jt],
                T_rv_w=convert.se3(jT, "cpu"),
                single=[convert.events(e) for e in single],
                shard=[convert.events(e) for e in shard])
    return dict(mappers=jm, trajs=jt, T_rv_w=jT, shard=shard), port


def rank_outputs(rig, out_dir, jobs_of):
    """{(kind, backend, shape): outputs} of the port's sharded (voting) step
    on 4 ranks for every (kind, backend) of `jobs_of` and every mesh; the
    plane groups' DSI blocks put back together in plane order, after
    checking that every event row holds the same blocks and every rank the
    same 2D maps."""
    _, t = rig
    spec = tsharded.rig_spec_from_mappers(t["mappers"])
    jobs = {}
    for ne, npl in MESHES:
        args = tsharded.sharded_step_inputs(t["mappers"], t["shard"], t["trajs"],
                                            t["T_rv_w"], ne, PACKET)
        for kind, b in jobs_of:
            cfg = tsharded.ShardedStepConfig(fusion_method=2, packet_size=PACKET,
                                             backend=BACKENDS[b])
            jobs[f"{kind}-{b}-{ne}x{npl}"] = ((ne, npl), kind, spec, cfg, args)
    spawn_ranks(sharded_steps, 4, (jobs, out_dir), timeout=240)
    out = {}
    for name, ((ne, npl), kind, *_rest) in jobs.items():
        ranks = [dict(np.load(os.path.join(out_dir, f"{name}.rank{r}.npz"))) for r in range(4)]
        for e in range(1, ne):
            for p in range(npl):
                for k, v in ranks[p].items():
                    np.testing.assert_array_equal(ranks[e * npl + p][k], v, err_msg=name)
        res = dict(ranks[0])
        res["dsi"] = np.concatenate([ranks[p]["dsi"] for p in range(npl)],
                                    axis=0 if kind == "step" else 1)
        _, b, shape = name.split("-")
        out[(kind, b, shape)] = res
    return out


def jax_run(rig, kind, backend, shape):
    """The JAX sharded (voting) step on `shape` over the first devices."""
    j, _ = rig
    spec = jsharded.rig_spec_from_mappers(j["mappers"])
    cfg = jsharded.ShardedStepConfig(fusion_method=2, packet_size=PACKET,
                                     backend=BACKENDS[backend])
    make = jsharded.make_sharded_step if kind == "step" else jsharded.make_sharded_voting_step
    args = jsharded.sharded_step_inputs(j["mappers"], j["shard"], j["trajs"], j["T_rv_w"],
                                        shape[0], PACKET)
    out = make(jmesh.make_mesh(*shape), spec, cfg)(*args)
    if kind != "step":
        return {"dsi": np.asarray(out)}
    return {k: np.asarray(v) for k, v in out.items()}


def port_single(rig, backend, kind):
    """The port's single-device voting of the same packets, warped through
    the LUT as the sharded step warps: each camera's DSI ("voting"), or
    their HM fusion and its depth map ("step")."""
    _, t = rig
    dsis = [tmapper.evaluate_dsi(m, ev, tr, t["T_rv_w"], packet_size=PACKET,
                                 backend=BACKENDS[backend], rectify="lut", pad="none")
            for m, ev, tr in zip(t["mappers"], t["single"], t["trajs"])]
    if kind != "step":
        return {"dsi": np.stack([to_np(d) for d in dsis])}
    fused = tgrid.fuse_many(dsis, 2)
    dm = tmapper.get_depth_map(t["mappers"][0], fused,
                               tsharded.ShardedStepConfig().extract_options)
    return dict(dsi=to_np(fused), depth_indices=to_np(dm.depth_indices),
                confidence=to_np(dm.confidence))


def _l1(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return np.abs(a - b).sum() / np.abs(b).sum()


def gate_stats(got, want):
    """(correlation, mass ratio - 1) of `got`'s DSI against `want`'s."""
    a, b = want["dsi"].astype(np.float64), got["dsi"].astype(np.float64)
    return np.corrcoef(a.ravel(), b.ravel())[0, 1], b.sum() / a.sum() - 1


def passes_gate(got, want, kind) -> bool:
    """tests/test_parallel.py:156-189's statistical gate of the production
    spec (per camera for the voting step, which has no depth map)."""
    if kind == "voting":
        return all(passes_gate({"dsi": got["dsi"][c]}, {"dsi": want["dsi"][c]}, "camera")
                   for c in range(2))
    corr, mass = gate_stats(got, want)
    ok = corr > 0.9 and abs(mass) < 1e-2
    if kind == "step":
        conf = want["confidence"]
        sel = conf > np.quantile(conf, 0.8)
        ei = np.abs(want["depth_indices"][sel].astype(int) - got["depth_indices"][sel].astype(int))
        ok = ok and np.mean(ei <= 1) >= 0.8 and np.mean(ei <= 2) >= 0.9 and np.median(ei) <= 1
    return ok


def check_vs_jax(got, want, backend, kind):
    assert got["dsi"].shape == want["dsi"].shape
    if backend == "scatter":
        assert _l1(got["dsi"], want["dsi"]) < 1e-4
        if kind == "step":
            assert np.mean(got["depth_indices"] == want["depth_indices"]) >= 0.999
    elif backend == "g1ss2":
        np.testing.assert_allclose(got["dsi"], want["dsi"], rtol=1e-3, atol=1e-3)
        if kind == "step":
            np.testing.assert_array_equal(got["depth_indices"], want["depth_indices"])
    else:
        assert passes_gate(got, want, kind)
    if kind == "step":
        for k in ("depth", "confidence", "mask"):
            assert got[k].shape == want[k].shape and np.isfinite(got[k]).all()


def check_vs_single(got, ref, backend, kind, shape):
    if backend == "scatter":
        if shape[0] == 1:
            np.testing.assert_array_equal(got["dsi"], ref["dsi"])
            if kind == "step":
                np.testing.assert_array_equal(got["depth_indices"], ref["depth_indices"])
        else:
            np.testing.assert_allclose(got["dsi"], ref["dsi"], rtol=1e-5, atol=1e-5)
            if kind == "step":
                assert np.mean(got["depth_indices"] == ref["depth_indices"]) >= 0.999
    elif backend == "g1ss2":
        np.testing.assert_allclose(got["dsi"], ref["dsi"], rtol=1e-3, atol=1e-3)
        if kind == "step":
            np.testing.assert_array_equal(got["depth_indices"], ref["depth_indices"])
    else:
        raise ValueError("the production spec is held by check_pl_vs_single")


def check_pl_vs_single(got, ref, jax_mesh, jax_one, kind):
    """The production spec against the port's single device: the gate, its
    correlation and mass limits widened to what the JAX package's own mesh
    run shows against its one-device run on the same mesh (with the gate's
    margins: correlation 0.01 lower, mass 1e-2 further)."""
    pairs = [(got, ref, jax_mesh, jax_one)] if kind == "step" else [
        tuple({"dsi": x["dsi"][c]} for x in (got, ref, jax_mesh, jax_one)) for c in range(2)]
    for g, r, jm, j1 in pairs:
        corr, mass = gate_stats(g, r)
        jcorr, jmass = gate_stats(jm, j1)
        assert corr > min(0.9, jcorr - 0.01), (corr, jcorr)
        assert abs(mass) < max(1e-2, abs(jmass) + 1e-2), (mass, jmass)
    if kind == "step":
        conf = ref["confidence"]
        sel = conf > np.quantile(conf, 0.8)
        ei = np.abs(ref["depth_indices"][sel].astype(int) - got["depth_indices"][sel].astype(int))
        assert np.mean(ei <= 1) >= 0.8 and np.mean(ei <= 2) >= 0.9 and np.median(ei) <= 1
