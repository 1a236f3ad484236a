"""The calibrated rig (the schema in `harness.py`'s docstring), on the CPU:
the three configurations' rigs of two pinhole cameras give the streams and
reference outputs the harness of two x-shifted pinhole cameras gave, bit
for bit; the reference's undistortion inverts the generator's distortion;
the n-ary harmonic-mean chain.

    python -m pytest benchmark/tests/test_rig.py -q
"""

import copy
import hashlib

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import emvs
from benchmark.tests import _cells
from benchmark.traffic import generate as traffic

SEED = 2**31 + 77
# sha256 of each configuration's streams and of its reference outputs at
# `_cells.tiny`'s size, its segment cut to 2 windows, from the harness of
# two pinhole cameras before the rig became a list of cameras.
PARENT = {
    "dsec_zurich04.replay_dense": (
        "d7d61ee93c39a0f212cf7a9374c49c8f0a506c57ea825f1fbb747903375422a3",
        "791d5dc13a613055475909e0d289762356e1cd4d00cad678117807a5d19ebc98"),
    "mvsec_flying1_athc.replay": (
        "50dc137c44fce8323e2c68331a0c93aca8d2f618bdb138f602464fd04a8b7e00",
        "43b06ab2d89b933b7fc5b8769f4ef2a19159757da9e8324c4e9de09f507d608a"),
    "tumvie_bike_easy3.replay_3m": (
        "b43d578675908ff6cf0f6e2b002328fcbf4c8ab8d504f2c68e7352b57671ee8b",
        "157c7e9c380939246b642509d42e0dcc063924e6f0b3f5cf3834f44bc5a3b3d7"),
}


def _two_windows(cell) -> harness.Cell:
    c = _cells.tiny(cell)
    start, _, duration, out_skip = traffic.segment(c.config)
    cut = start + duration + out_skip
    c.config["flags"] = [f if not f.startswith("--stop_time_s") else f"--stop_time_s={cut!r}"
                         for f in c.config["flags"]]
    return c


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = a.detach().cpu().contiguous().numpy() if isinstance(a, torch.Tensor) \
            else np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _reference_arrays(c: harness.Cell, streams) -> list:
    ref = harness.Reference(c.config, streams, traffic.pose_arrays(c.config))
    assert len(ref.chunks) == 2
    arrays = []
    for k in range(len(ref.chunks)):
        out = ref.outputs(k, "cpu")
        arrays += list(out["cams"])
        for d, m in out["extractions"]:
            arrays += [d, m["depth"], m["confidence"], m["mask"]]
    return arrays


@pytest.mark.parametrize("cell", sorted(PARENT))
def test_two_camera_form_is_bit_identical(cell):
    c = _two_windows(cell)
    streams = traffic.generate(c.config, c.mix, SEED, "cpu")
    assert _digest([a for s in streams for a in s]) == PARENT[cell][0]
    assert _digest(_reference_arrays(c, streams)) == PARENT[cell][1]


@pytest.mark.parametrize("cell", sorted(PARENT))
def test_configuration_is_two_pinhole_cameras_on_an_x_baseline(cell):
    """Each configuration's rig is what its hashes were recorded from: two
    undistorted cameras sharing K, P = K, camera 1 at +baseline in x."""
    rig = harness.load_cell(cell).config["rig"]
    cams = traffic.cameras(rig)
    assert len(cams) == 2 and traffic.projection(rig) == cams[0]["K"] == cams[1]["K"]
    assert all(c["distortion"] == "none" and c["R"] is None for c in cams)
    assert traffic.hand_eye(rig) is None
    T = cams[1]["T_i_0"]
    assert np.array_equal(T[:3, :3], np.eye(3)) and T[0, 3] < 0 and not T[1:3, 3].any()
    port = harness.calibration(rig)
    assert np.array_equal(port.extrinsics(1), T)
    assert all(np.array_equal(c.P, c.K) for c in port.cams)


def test_rectifying_rotation_is_a_turn_of_the_raw_sensor():
    """A camera with a rectifying R at T_i_0 sees what a camera without one
    sees at [R^T | 0] T_i_0: the same events, but for a pixel's rounding."""
    c = _cells.tiny(_cells.evimo2())
    a = np.deg2rad(2.0)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    turned = copy.deepcopy(c)
    cam = c.config["rig"]["cameras"][1]
    cam["R"] = R.tolist()
    T = np.eye(4)
    T[:3, :3] = R.T
    turned.config["rig"]["cameras"][1]["T_i_0"] = (T @ np.asarray(cam["T_i_0"])).tolist()
    x0, y0, t0 = traffic.generate(c.config, c.mix, SEED, "cpu")[1]
    x1, y1, t1 = traffic.generate(turned.config, turned.mix, SEED, "cpu")[1]
    assert np.array_equal(t0, t1)
    assert np.mean((x0 == x1) & (y0 == y1)) > 0.999


def test_rig_schema_refuses_what_it_cannot_mean():
    rig = copy.deepcopy(_cells.evimo2().config["rig"])
    assert len(traffic.cameras(rig)) == 3
    bad = copy.deepcopy(rig)
    bad["cameras"][0]["T_i_0"] = bad["cameras"][1]["T_i_0"]
    with pytest.raises(ValueError):
        traffic.cameras(bad)
    bad = copy.deepcopy(rig)
    bad["cameras"][1]["distortion"] = "kb8"
    with pytest.raises(ValueError):
        traffic.cameras(bad)
    for n in (1, 4):
        bad = copy.deepcopy(rig)
        bad["cameras"] = (bad["cameras"] * 2)[:n]
        with pytest.raises(ValueError):
            traffic.cameras(bad)


# (model, K as fx, fy, cx, cy, D, width, height): EVIMO2's camera 0
# (dvs_mcemvs_torch/io/calib.py calib_evimo2) and DVS Gen3's camera 0, its
# equidistant model (calib_dvsgen3).
LENSES = {
    "radtan": ([519.638, 519.384, 321.661, 240.727],
               [0.108306, -0.154485, 0.00103538, -0.000401824], 640, 480),
    "radtan_k3": ([198.9035679113487, 198.8472302496314, 139.8751842835105, 104.0170363461823],
                  [-0.3693817071651257, 0.1677750957297015, 0.0007676172676998043,
                   -0.001200264930281811, 0.02], 240, 180),
    "equidistant": ([312.792763, 312.783965, 332.917834, 243.939008],
                    [-0.0725278887080172, -0.016272832786070585, 0.018086976118303524,
                     -0.006273794980217994], 640, 480),
}


@pytest.mark.parametrize("lens", sorted(LENSES))
def test_undistortion_inverts_the_forward_model(lens):
    """Every pixel of the sensor, as an undistorted point through the
    generator's forward model and back through the reference's
    undistortion, lands within 1e-9 px of where it started."""
    (fx, fy, cx, cy), D, W, H = LENSES[lens]
    model = lens.split("_")[0]
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float64),
                            torch.arange(W, dtype=torch.float64), indexing="ij")
    xn, yn = (xs.reshape(-1) - cx) / fx, (ys.reshape(-1) - cy) / fy
    xd, yd, monotone = traffic.distort(model, D, xn, yn)
    assert bool(monotone.all())
    cam = emvs.Camera(fx, fy, cx, cy, model, tuple(D))
    X, Y, Z = cam.rays(fx * xd + cx, fy * yd + cy, "cpu")
    err = torch.hypot(fx * (X / Z - xn), fy * (Y / Z - yn))
    assert float(err.max()) < 1e-9, float(err.max())


def test_rays_apply_the_rectifying_rotation():
    a = np.deg2rad(3.0)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    plain = emvs.Camera(70.0, 71.0, 39.5, 29.5)
    rect = emvs.Camera(70.0, 71.0, 39.5, 29.5, R=tuple(R.ravel()))
    x, y = np.array([0.0, 10.0, 79.0]), np.array([0.0, 30.0, 59.0])
    b = torch.stack(plain.rays(x, y, "cpu"), -1).numpy()
    assert np.allclose(torch.stack(rect.rays(x, y, "cpu"), -1).numpy(), b @ R.T, atol=1e-15)


def test_harmonic_mean_chain(monkeypatch):
    g = torch.Generator().manual_seed(5)
    a, b, c = (torch.rand(4, 6, 7, generator=g, dtype=torch.float64) + 0.1 for _ in range(3))
    assert torch.equal(emvs.fuse_hm_chain([a, b]), emvs.fuse_hm(a, b))
    monkeypatch.setattr(emvs, "HM_EPS", 0.0)
    assert torch.allclose(emvs.fuse_hm_chain([a, b, c]), 3 / (1 / a + 1 / b + 1 / c),
                          rtol=1e-14, atol=0)
    d = torch.rand(4, 6, 7, generator=g, dtype=torch.float64) + 0.1
    assert torch.allclose(emvs.fuse_hm_chain([a, b, c, d]),
                          4 / (1 / a + 1 / b + 1 / c + 1 / d), rtol=1e-14, atol=0)


def test_harmonic_mean_chain_is_the_programs():
    from dvs_mcemvs_torch.ops import grid

    g = torch.Generator().manual_seed(6)
    grids = [torch.rand(3, 5, 5, generator=g) * 4 for _ in range(3)]
    assert torch.equal(emvs.fuse_hm_chain(grids), grid.fuse_many(grids, grid.FUSE_HM))
