"""The port's distributed layer (`dvs_mcemvs_torch.parallel`) against the
JAX package's on the CPU: mesh factorizations, the padded step inputs, the
process group's set-up, and the sharded step and sharded voting step under
the exact `scatter` backend on 4 gloo CPU ranks (spawned processes, one
torch thread each) on meshes (4, 1), (1, 4) and (2, 2), held to the JAX
sharded step on the same mesh and to the port's single device
(tolerances in tests/_torch_sharded.py).  The hist backends' sharded runs
are in tests/test_torch_sharded_hist.py and test_torch_sharded_pl*.py.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_sharded as S

from dvs_mcemvs_tpu.parallel import mesh as jmesh, sharded as jsharded
from dvs_mcemvs_torch.parallel import mesh as tmesh, sharded as tsharded

PACKET = S.PACKET
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n_dev,dim_z,backend,max_plane", [
    (8, 16, None, 8), (8, 100, None, 4), (1, 100, None, 8), (8, 7, None, 8),
    (8, 100, "hist:g16,seg16,bf,pl", 8), (8, 16, "hist_exact", 8), (8, 16, "hist", 8),
    (8, 100, "scatter", 8), (8, 16, "scatter", 8), (8, 100, "sort", 4), (6, 9, "sort", 8),
    (12, 100, "scatter", 8), (2, 32, "scatter", 8)])
def test_pick_mesh_shape_matches_jax(n_dev, dim_z, backend, max_plane):
    assert tmesh.pick_mesh_shape(n_dev, dim_z, max_plane, backend) == \
        jmesh.pick_mesh_shape(n_dev, dim_z, max_plane, backend)


@pytest.mark.parametrize("n_dev,n_proc", [(8, 1), (8, 2), (8, 4), (8, 8), (4, 2), (6, 3),
                                          (2, 1), (1, 1)])
@pytest.mark.parametrize("dim_z,backend", [(16, None), (100, "scatter"), (7, "sort"),
                                           (100, "hist:g16,seg16,bf,pl")])
def test_global_mesh_shape_matches_jax(monkeypatch, n_dev, n_proc, dim_z, backend):
    """JAX's `global_mesh` on the first `n_dev` virtual devices, as if they
    lay in `n_proc` processes."""
    devices = jax.devices()[:n_dev]
    monkeypatch.setattr(jax, "devices", lambda *a: devices)
    monkeypatch.setattr(jax, "process_count", lambda: n_proc)
    want = jmesh.global_mesh(dim_z, backend=backend).devices.shape
    assert tmesh.global_mesh_shape(n_dev, n_proc, dim_z, backend=backend) == want


@pytest.fixture(scope="module")
def rig():
    return S.build_rig()


@pytest.mark.parametrize("n_event,extra", [(1, None), (4, None), (3, None), (2, 3)])
def test_step_inputs_match_jax(rig, n_event, extra):
    """pad_events_for_sharding, pad_events_local, replicated_step_tables
    and sharded_step_inputs give JAX's arrays exactly, with and without an
    explicit capacity (`extra` packets past the longest stream)."""
    j, t = rig
    capacity = None if extra is None else max(e.num for e in j["shard"]) + extra * PACKET
    want = jsharded.sharded_step_inputs(j["mappers"], j["shard"], j["trajs"], j["T_rv_w"],
                                        n_event, PACKET, capacity)
    got = tsharded.sharded_step_inputs(t["mappers"], t["shard"], t["trajs"], t["T_rv_w"],
                                       n_event, PACKET, capacity)
    assert len(got) == len(want) == 13
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    for g, w in zip(tsharded.pad_events_local(t["shard"], n_event * PACKET, capacity),
                    jsharded.pad_events_local(j["shard"], n_event * PACKET, capacity)):
        np.testing.assert_array_equal(g, w)


def test_pad_events_refuses_a_short_capacity(rig):
    _, t = rig
    with pytest.raises(ValueError, match="capacity"):
        tsharded.pad_events_for_sharding(t["shard"], 1, PACKET, capacity=PACKET)


# ---------------------------------------------------------------------------
# The sharded step and the sharded voting step under `scatter` on 4 gloo CPU
# ranks (tolerances in tests/_torch_sharded.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rank_outputs(rig, tmp_path_factory):
    return S.rank_outputs(rig, str(tmp_path_factory.mktemp("ranks")),
                          [("step", "scatter"), ("voting", "scatter")])


@pytest.mark.parametrize("kind", ["step", "voting"])
@pytest.mark.parametrize("shape", S.MESHES, ids=S.MESH_IDS)
def test_sharded_scatter_matches_jax_sharded(rig, rank_outputs, shape, kind):
    got = rank_outputs[(kind, "scatter", f"{shape[0]}x{shape[1]}")]
    S.check_vs_jax(got, S.jax_run(rig, kind, "scatter", shape), "scatter", kind)


@pytest.mark.parametrize("kind", ["step", "voting"])
@pytest.mark.parametrize("shape", S.MESHES, ids=S.MESH_IDS)
def test_sharded_scatter_matches_single_device(rig, rank_outputs, shape, kind):
    got = rank_outputs[(kind, "scatter", f"{shape[0]}x{shape[1]}")]
    S.check_vs_single(got, S.port_single(rig, "scatter", kind), "scatter", kind, shape)


def test_make_mesh_needs_a_group_and_enough_ranks(monkeypatch):
    """Without a process group make_mesh raises; with no card and no CPU
    asked for it raises as the other entry points do."""
    with pytest.raises(RuntimeError, match="init_distributed"):
        tmesh.make_mesh(1, 1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh(1, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.init_distributed("127.0.0.1:1", 1, 0)


def test_init_distributed_reads_the_launcher_environment(monkeypatch):
    """Values left None come from MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK;
    a missing one raises, naming it.  A world of one rank on the CPU: the
    mesh is (1, 1), and a second call returns the same rank."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        tmesh.init_distributed("127.0.0.1:1", None, 0, "cpu")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(tmesh.free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    try:
        assert tmesh.init_distributed(device="cpu") == (0, 1)
        assert tmesh.init_distributed(device="cpu") == (0, 1)
        mesh = tmesh.make_mesh(1, 1, device="cpu")
        assert mesh.mesh_dim_names == ("event", "plane") and list(mesh.get_coordinate()) == [0, 0]
        with pytest.raises(ValueError, match="need 2 ranks"):
            tmesh.make_mesh(2, 1, device="cpu")
    finally:
        tmesh.shutdown_distributed()


def test_chip_smoke_distributed_rehearses_on_cpu(monkeypatch):
    """Phase 10 at a tiny size on the CPU (gloo ranks, the kernels' plain
    versions): (a) one rank, (b) two spawned ranks on meshes (2, 1) and
    (1, 2), (c) the CLI as two processes, each against its one-device run;
    and (a) refuses a run that launched no kernel.  Groups of 2 packets in
    2 segments keep each rank's groups those of the one-device run, as the
    headline chunk's do at full size."""
    sys.path.insert(0, REPO)
    import chip_smoke

    # The spawned ranks and CLI processes take one thread each.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cpu = torch.device("cpu")
    size = dict(n_events=16384, width=96, height=64, dim_z=20, n_pts=2000)
    workload = chip_smoke.build_workload(cpu, **size)
    spec = "hist:g2,seg2,bf,pl"
    with pytest.raises(AssertionError, match="not launched"):
        chip_smoke.distributed_phase(cpu, workload, spec=spec, runs=1, rank_size=size)
    out = chip_smoke.distributed_phase(cpu, workload, spec=spec, runs=1, rank_size=size,
                                       needed=())
    assert out["a"]["backend"] == "gloo" and out["a"]["l1"] < 1e-6
    for rank in out["b"]:
        assert rank["backend"] == "gloo"
        assert all(rank[m]["equal"] == 1.0 for m in ("2x1", "1x2"))
        assert rank["all_reduce_s"] > 0
    assert all(out["c"][pm]["equal"] >= chip_smoke.DIST_EQUAL for pm in (1, 2))
