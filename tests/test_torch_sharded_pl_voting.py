"""The port's sharded voting step (process_2/5's) under the production spec form
`hist:g4,ss2,seg4,bf,pl` on 4 gloo CPU ranks, meshes (4, 1), (1, 4) and
(2, 2), against the JAX sharded voting step on the same mesh and against the
port's single device, under tests/test_parallel.py:156-189's statistical
gate (details in tests/_torch_sharded.py).
"""

import pytest

import _torch_sharded as S


@pytest.fixture(scope="module")
def rig():
    return S.build_rig()


@pytest.fixture(scope="module")
def rank_outputs(rig, tmp_path_factory):
    return S.rank_outputs(rig, str(tmp_path_factory.mktemp("ranks")), [("voting", "pl")])


@pytest.fixture(scope="module")
def jax_runs(rig):
    """The JAX sharded runs on every mesh and on one device."""
    return {shape: S.jax_run(rig, "voting", "pl", shape) for shape in S.MESHES + [(1, 1)]}


@pytest.mark.parametrize("shape", S.MESHES, ids=S.MESH_IDS)
def test_sharded_pl_voting_matches_jax_sharded(rank_outputs, jax_runs, shape):
    got = rank_outputs[("voting", "pl", f"{shape[0]}x{shape[1]}")]
    S.check_vs_jax(got, jax_runs[shape], "pl", "voting")


@pytest.mark.parametrize("shape", S.MESHES, ids=S.MESH_IDS)
def test_sharded_pl_voting_matches_single_device(rig, rank_outputs, jax_runs, shape):
    got = rank_outputs[("voting", "pl", f"{shape[0]}x{shape[1]}")]
    S.check_pl_vs_single(got, S.port_single(rig, "pl", "voting"), jax_runs[shape],
                         jax_runs[(1, 1)], "voting")
