"""scripts/scaling_bench_torch.py, the port's sharding-overhead protocol,
against scripts/scaling_bench.py on the CPU.

Both scripts are cut to tests/test_scaling_bench.py's size (64x48x16,
4,096 events, 256-event packets) and hold: the same constants, spec, mesh
list and shipped default; the same workload (events equal to the bit, the
trajectory and the reference view within 1e-6); the port's timed rows on
gloo CPU ranks (one torch thread each) with each mesh's step output held
to the JAX script's step on the same mesh over the virtual CPU devices of
tests/conftest.py; the report's fields; the committed SCALING_TORCH.json;
and chip_smoke.py phase 15 rehearsed on the CPU.
"""

import ast
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import _torch_sharded as S

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

SIZE = dict(WIDTH=64, HEIGHT=48, DIM_Z=16, N_EVENTS=4096, PACKET=256)
MESHES = [(1, 1), (2, 2)]
SCALING_JSON = os.path.join(REPO, "SCALING.json")


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "_scaling_bench_jax", os.path.join(REPO, "scripts", "scaling_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_meshes() -> list:
    """The mesh list of scripts/scaling_bench.py's main (a local there)."""
    with open(os.path.join(REPO, "scripts", "scaling_bench.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    node = next(n for n in ast.walk(main) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "meshes")
    return [tuple(m) for m in ast.literal_eval(node.value)]


@pytest.fixture
def scripts(monkeypatch):
    """(JAX script, port script), both cut to SIZE.  The port's is
    chip_smoke.py's copy, registered under its own name so that the ranks
    it spawns import it."""
    jsb, tsb = _jax_script(), chip_smoke.script("scaling_bench_torch")
    for k, v in SIZE.items():
        monkeypatch.setattr(jsb, k, v)
        monkeypatch.setattr(tsb, k, v)
    return jsb, tsb


def test_constants_spec_and_meshes_match():
    from dvs_mcemvs_tpu.parallel import pick_mesh_shape as jpick
    from dvs_mcemvs_torch.ops import voting as tvoting
    from dvs_mcemvs_torch.parallel import pick_mesh_shape as tpick

    jsb, tsb = _jax_script(), chip_smoke.script("scaling_bench_torch")
    for name in ("WIDTH", "HEIGHT", "DIM_Z", "N_EVENTS", "PACKET", "BACKEND"):
        assert getattr(tsb, name) == getattr(jsb, name), name
    assert (tsb.WIDTH, tsb.HEIGHT, tsb.DIM_Z, tsb.N_EVENTS) == (320, 240, 64, 262_144)
    assert [tuple(m) for m in tsb.MESHES] == _jax_meshes()
    assert callable(tvoting.resolve_backend(tsb.BACKEND))
    assert ",pl" not in tsb.BACKEND and "bf" not in tsb.BACKEND
    for dim_z in (64, tsb.DIM_Z):
        assert tuple(tpick(8, dim_z, backend=tsb.BACKEND)) == \
            tuple(jpick(8, dim_z, backend=jsb.BACKEND)) == (8, 1)


def test_build_matches_jax(scripts):
    jsb, tsb = scripts
    jm, jev, jtraj, jT = jsb.build()
    tm, tev, ttraj, tT = tsb.build("cpu")
    for k in ("x", "y", "t", "p"):
        a, b = getattr(tev, k), np.asarray(getattr(jev, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert tev.num == jev.num == SIZE["N_EVENTS"]
    for got, want in ((ttraj.ts, jtraj.ts), (ttraj.poses.q, jtraj.poses.q),
                      (ttraj.poses.t, jtraj.poses.t), (tT.q, jT.q), (tT.t, jT.t)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm.lut, np.asarray(jm.lut), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm.depth_vec.depths(), jm.depth_vec.depths(), rtol=1e-6)


def _jax_step(jsb, workload, ne, npl) -> dict:
    """One step of the JAX script's `time_mesh` on (ne, npl), over the
    first ne * npl virtual CPU devices."""
    from dvs_mcemvs_tpu.parallel import make_mesh, sharded

    mapper, events, traj, T_rv_w = workload
    spec = sharded.ShardedRigSpec(
        n_cameras=1, width=mapper.width, height=mapper.height,
        dim_z=mapper.depth_vec.n, z0=float(mapper.depth_vec.depths()[0]),
        vcam_params=(float(mapper.vcam.fx), float(mapper.vcam.fy),
                     float(mapper.vcam.cx), float(mapper.vcam.cy)))
    cfg = sharded.ShardedStepConfig(fusion_method=2, packet_size=jsb.PACKET,
                                    backend=jsb.BACKEND)
    step = sharded.make_sharded_step(make_mesh(ne, npl), spec, cfg)
    out = step(*sharded.sharded_step_inputs([mapper], [events], [traj], T_rv_w, ne,
                                            jsb.PACKET))
    return {k: np.asarray(v) for k, v in out.items()}


def test_rows_time_and_match_jax(scripts):
    """The port's rows on (1, 1) and (2, 2): positive times and spreads,
    gloo ranks; rank 0's step output against the JAX script's step on the
    same mesh (rank 0's DSI block against the same planes), within
    tests/_torch_sharded.py's tolerance for `hist:g1,ss2` (DSI within 1e-3,
    depth indices equal), confidence within 1e-3 and the mask equal.  The
    grouped spec is held to the exact grouping's tolerance because both
    packages group the same packets here (the outputs agree to the bit at
    this size); its statistical gate holds too."""
    jsb, tsb = scripts
    rows = tsb.run(MESHES, "cpu", timeout=300)
    assert [tuple(r["mesh"]) for r in rows] == MESHES
    workload = jsb.build()
    for row in rows:
        assert row["seconds_per_step"] > 0 and row["run_spread_rel"] >= 0
        assert row["backend"] == "gloo" and row["ranks"] == row["mesh"][0] * row["mesh"][1]
        ne, npl = row["mesh"]
        want = _jax_step(jsb, workload, ne, npl)
        got = dict(row["out"])
        zb = SIZE["DIM_Z"] // npl
        want["dsi"] = want["dsi"][:zb]
        S.check_vs_jax(got, want, "g1ss2", "step")
        np.testing.assert_allclose(got["confidence"], want["confidence"], rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_array_equal(got["mask"], want["mask"])
        assert S.passes_gate(got, want, "step"), row["mesh"]
        assert row["equal_to_1x1"] >= 0.0
    tsb.check_rows(rows, MESHES, "cpu")


def _fabricated_rows():
    return [{"mesh": list(m), "seconds_per_step": 0.004 * (1 + i), "run_spread_rel": 0.01,
             "backend": "gloo", "ranks": m[0] * m[1],
             "launches": {"bin_events": 0, "banded_resample_sum": 0}}
            for i, m in enumerate(chip_smoke.script("scaling_bench_torch").MESHES)]


def test_report_fields_match_scaling_json():
    tsb = chip_smoke.script("scaling_bench_torch")
    rep = tsb.report(_fabricated_rows(), (8, 1), "NVIDIA H100 80GB HBM3, 700.00 W")
    with open(SCALING_JSON) as f:
        ref = json.load(f)
    assert chip_smoke.scaling_fields_match(rep, ref) == []
    for row in rep["results"]:
        assert set(row) == set(ref["results"][0]) | {"backend", "ranks"}
    assert sum(r["is_shipped_default"] for r in rep["results"]) == 1
    assert "min over 6" in rep["summary"]["caveat"]
    assert "NVIDIA H100" in rep["summary"]["caveat"]
    assert rep["summary"]["two_host_efficiency_floor"] == 0.5
    assert rep["summary"]["eight_shard_efficiency_floor"] == 0.25
    assert rep["summary"]["meets_target"] is False
    assert rep["results"][1]["overhead_vs_1dev"] == pytest.approx(1.0)
    bad = json.loads(json.dumps(rep))
    del bad["results"][2]["ranks"]
    bad["summary"]["extra"] = 1
    assert len(chip_smoke.scaling_fields_match(bad, ref)) == 2


def test_check_rows_refuses_bad_rows():
    tsb = chip_smoke.script("scaling_bench_torch")
    rows = _fabricated_rows()
    tsb.check_rows(rows, tsb.MESHES, "cpu")
    with pytest.raises(AssertionError, match="kernels not launched"):
        tsb.check_rows(rows, tsb.MESHES, "cuda:0")
    with pytest.raises(AssertionError, match="rows"):
        tsb.check_rows(rows[:-1], tsb.MESHES, "cpu")
    rows[3] = dict(rows[3], seconds_per_step=float("nan"))
    with pytest.raises(AssertionError, match="finite"):
        tsb.check_rows(rows, tsb.MESHES, "cpu")


def test_committed_scaling_torch_matches_protocol():
    """SCALING_TORCH.json, from a run on the card: every mesh of the
    protocol in order, SCALING.json's fields plus `backend` and `ranks`,
    and a caveat naming the NVIDIA card and its power limit."""
    tsb = chip_smoke.script("scaling_bench_torch")
    with open(os.path.join(REPO, "SCALING_TORCH.json")) as f:
        rep = json.load(f)
    with open(SCALING_JSON) as f:
        ref = json.load(f)
    assert chip_smoke.scaling_fields_match(rep, ref) == []
    assert [tuple(r["mesh"]) for r in rep["results"]] == [tuple(m) for m in tsb.MESHES]
    assert rep["workload"] == {"events": 262_144, "dsi": [64, 240, 320],
                               "backend": tsb.BACKEND, "packet": 512}
    assert sum(r["is_shipped_default"] for r in rep["results"]) == 1
    assert rep["summary"]["shipped_default_mesh_8dev"] == [8, 1]
    for row in rep["results"]:
        assert np.isfinite(row["seconds_per_step"]) and row["seconds_per_step"] > 0
        assert row["ranks"] == row["mesh"][0] * row["mesh"][1]
        # One spawn of 8 ranks sharing the card runs every row.
        assert row["backend"] == "gloo"
    caveat = rep["summary"]["caveat"]
    assert "min over 6" in caveat and "NVIDIA" in caveat and " W" in caveat


def test_chip_smoke_scaling_rehearses_on_cpu(scripts):
    """Phase 15 on gloo CPU ranks at the small size: all six meshes, the
    table, the report's fields against SCALING.json's."""
    res = chip_smoke.scaling_phase(torch.device("cpu"))
    rep = res["report"]
    assert [tuple(r["mesh"]) for r in rep["results"]] == \
        [tuple(m) for m in chip_smoke.script("scaling_bench_torch").MESHES]
    assert rep["workload"]["events"] == SIZE["N_EVENTS"]
    assert all(r["backend"] == "gloo" and r["ranks"] == r["mesh"][0] * r["mesh"][1]
               for r in rep["results"])
    assert res["launches"] == {"bin_events": 0, "banded_resample_sum": 0}
