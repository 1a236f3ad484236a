"""The DSEC loaders and the evaluation script of the PyTorch port against
the JAX package, on the CPU.

The loaders are host numpy code copied from the JAX module, so every
result must be equal, bit for bit.  The two scripts (scripts/evaluate_dsec.py
and scripts/evaluate_dsec_torch.py) run by subprocess on the same run
directory and ground truth, and print the same JSON.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from dvs_mcemvs_tpu.eval import dsec as jdsec
from dvs_mcemvs_torch.eval import dsec as tdsec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K_TARGET = np.array([[320.0, 0.0, 160.5], [0.0, 321.0, 120.25], [0.0, 0.0, 1.0]])


def _write_cam_to_cam(path, rng):
    """A cam_to_cam.yaml with the two entries the protocol reads."""
    import yaml

    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R *= np.sign(np.linalg.det(R))
    f, cx, cy, b = 300.0, 158.0, 121.0, 0.6
    Q = [[1.0, 0.0, 0.0, -cx], [0.0, 1.0, 0.0, -cy], [0.0, 0.0, 0.0, f],
         [0.0, 0.0, 1.0 / b, 0.0]]
    with open(path, "w") as fh:
        yaml.safe_dump({"disparity_to_depth": {"cams_03": Q},
                        "extrinsics": {"R_rect0": (R * 0.02 + np.eye(3)).tolist()}}, fh)


def _assert_masked_equal(got, want):
    np.testing.assert_array_equal(np.ma.getdata(got), np.ma.getdata(want))
    np.testing.assert_array_equal(np.ma.getmaskarray(got), np.ma.getmaskarray(want))


def test_load_eval_rig_yaml(tmp_path):
    path = str(tmp_path / "cam_to_cam.yaml")
    _write_cam_to_cam(path, np.random.default_rng(40))
    got = tdsec.load_eval_rig_yaml(path, K_TARGET, baseline=0.55)
    want = jdsec.load_eval_rig_yaml(path, K_TARGET, baseline=0.55)
    for f in ("Q", "T_rect0_0", "K_target"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.baseline == want.baseline and got.focal == want.focal


@pytest.mark.parametrize("shape", [None, (200, 300)], ids=["disparity-shape", "other-shape"])
def test_disparity_to_depth_map(tmp_path, shape):
    """Zero disparities dropped, points behind the camera and out of the
    image dropped, the last write winning where two points land on one
    pixel."""
    rng = np.random.default_rng(41)
    path = str(tmp_path / "cam_to_cam.yaml")
    _write_cam_to_cam(path, rng)
    rig = jdsec.load_eval_rig_yaml(path, K_TARGET)
    disp = rng.uniform(1.0, 60.0, (240, 320)).astype(np.float32)
    disp[rng.random(disp.shape) < 0.4] = 0.0
    got = tdsec.disparity_to_depth_map(disp, tdsec.load_eval_rig_yaml(path, K_TARGET), shape)
    want = jdsec.disparity_to_depth_map(disp, rig, shape)
    _assert_masked_equal(got, want)
    assert (~np.ma.getmaskarray(got)).sum() > 1000


@pytest.mark.parametrize("cv2_path", [True, False], ids=["cv2", "numpy-fallback"])
@pytest.mark.parametrize("thicken", [False, True], ids=["plain", "thicken"])
def test_load_depth_points(tmp_path, monkeypatch, cv2_path, thicken):
    """The `[col row depth]` file into a masked map; the 3x3-ellipse
    erosion through cv2 and through the numpy fallback (cv2 hidden), which
    must give the same map."""
    rng = np.random.default_rng(42)
    H, W = 30, 40
    ys, xs = np.nonzero(rng.random((H, W)) < 0.2)
    pts = np.stack([xs, ys, rng.uniform(1.0, 9.0, xs.size)], 1)
    path = str(tmp_path / "000.500000000depth_points_fused.txt")
    np.savetxt(path, pts)
    with_cv2 = tdsec.load_depth_points(path, (H, W), thicken_edges=thicken)
    if not cv2_path:
        monkeypatch.setitem(sys.modules, "cv2", None)
    got = tdsec.load_depth_points(path, (H, W), thicken_edges=thicken)
    want = jdsec.load_depth_points(path, (H, W), thicken_edges=thicken)
    _assert_masked_equal(got, want)
    _assert_masked_equal(got, with_cv2)
    empty = str(tmp_path / "empty.txt")
    open(empty, "w").close()
    _assert_masked_equal(tdsec.load_depth_points(empty, (H, W), thicken),
                         jdsec.load_depth_points(empty, (H, W), thicken))


def test_match_timestamps():
    rng = np.random.default_rng(43)
    est = np.sort(rng.uniform(0, 10, 40)).tolist()
    gt_us = (np.sort(rng.uniform(0, 10, 25)) + 100.0) * 1e6
    for max_dt in (0.1, 0.02, 1.0):
        got = tdsec.match_timestamps(est, gt_us, 100.0, max_dt)
        assert got == jdsec.match_timestamps(est, gt_us, 100.0, max_dt)
    assert tdsec.match_timestamps(est, gt_us, 100.0, 0.1)


def _run_both(args):
    """The JAX script's and the port script's JSON on the same flags."""
    out = []
    for script in ("scripts/evaluate_dsec.py", "scripts/evaluate_dsec_torch.py"):
        proc = subprocess.run([sys.executable, script, *args], capture_output=True,
                              text=True, cwd=REPO, timeout=120)
        assert proc.returncode == 0, proc.stderr
        out.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    return out


def test_evaluate_dsec_scripts_agree_on_npy_depth(tmp_path):
    """tests/test_eval.py's fixture: three matched frames of noisy
    semi-dense estimates, one GT frame far in time."""
    run, gt = tmp_path / "run", tmp_path / "gt"
    run.mkdir()
    gt.mkdir()
    rng = np.random.default_rng(0)
    H, W = 24, 32
    gt_times_us = []
    for k, t in enumerate([0.5, 1.5, 2.5]):
        depth = rng.uniform(2.0, 5.0, (H, W))
        ys, xs = np.nonzero(rng.random((H, W)) < 0.3)
        est = depth[ys, xs] + rng.normal(0, 0.05, ys.size)
        np.savetxt(run / f"{t:013.9f}depth_points_fused.txt", np.stack([xs, ys, est], 1))
        np.save(gt / f"{k:06d}.npy", depth)
        gt_times_us.append(t * 1e6)
    gt_times_us.append(50e6)
    np.save(gt / "000003.npy", np.ones((H, W)))
    ts_file = tmp_path / "ts.txt"
    np.savetxt(ts_file, np.asarray(gt_times_us))
    for extra in ([], ["--thicken_edges", "--start", "1.0"]):
        want, got = _run_both(["--run_dir", str(run), "--gt_timestamps", str(ts_file),
                               "--gt_depth_npy_dir", str(gt), "--width", str(W),
                               "--height", str(H), "--fx", "100.0", *extra])
        assert got == want
    assert got["frames_evaluated"] == 2 and want["frames_found"] == 2


def test_evaluate_dsec_scripts_agree_on_disparity_pngs(tmp_path):
    """The reference protocol: 16-bit disparity PNGs (read through cv2)
    and a cam_to_cam.yaml."""
    import cv2

    rng = np.random.default_rng(44)
    run, gtd, calib = tmp_path / "run", tmp_path / "disp", tmp_path / "calib"
    for d in (run, gtd, calib):
        d.mkdir()
    _write_cam_to_cam(str(calib / "cam_to_cam.yaml"), rng)
    H, W = 48, 64
    for k, t in enumerate([0.25, 0.75]):
        disp = (rng.uniform(5.0, 40.0, (H, W)) * 256).astype(np.uint16)
        disp[rng.random((H, W)) < 0.3] = 0
        cv2.imwrite(str(gtd / f"{2 * k:06d}.png"), disp)
        ys, xs = np.nonzero(rng.random((H, W)) < 0.3)
        np.savetxt(run / f"{t:013.9f}depth_points_fused.txt",
                   np.stack([xs, ys, rng.uniform(5.0, 40.0, ys.size)], 1))
    ts_file = tmp_path / "ts.txt"
    np.savetxt(ts_file, np.array([1000.25, 1000.75]) * 1e6)
    want, got = _run_both(["--run_dir", str(run), "--gt_timestamps", str(ts_file),
                           "--gt_disparity_dir", str(gtd), "--calib_dir", str(calib),
                           "--fx", "60.0", "--cx", "32.0", "--cy", "24.0", "--width", str(W),
                           "--height", str(H), "--event_start_time", "1000.0"])
    assert got == want and got["frames_evaluated"] == 2
