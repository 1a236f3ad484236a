"""Shared helpers of the PyTorch port's tests (tests/test_torch_*.py).

The suite runs on several xdist workers per host, so each worker caps its
torch thread pool.  JAX and torch meet only through numpy arrays.
"""

import os

import numpy as np
import torch

torch.set_num_threads(2)


def to_np(x) -> np.ndarray:
    """A tensor (any dtype, any device) or array as a float64-safe numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.numpy()
    return np.asarray(x)


def assert_rel_close(got, want, rel: float, what: str = "") -> None:
    """Elementwise |got - want| <= rel * max|want| (relative to the array's
    scale, so values near zero do not need their own tolerance)."""
    got, want = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rel, f"{what}: max error {err:.3g} of scale > {rel}"


def _points(path):
    pts = np.atleast_2d(np.loadtxt(path)).reshape(-1, 3)
    return {(int(r[0]), int(r[1])): r[2] for r in pts}


def assert_same_cli_artifacts(jdir: str, tdir: str, launch_flags: bool = False) -> None:
    """Two CLI output directories hold the same files; every depth map
    agrees on >= 99 % of the pixels both masks keep, and each keeps >= 98 %
    of the other's; every DSI dump within relative L1 1e-4; the same
    run_flags.conf but for --out_path (and, with `launch_flags`, for the
    flags that say how the run was launched: --num_devices, --coordinator,
    --num_processes, --process_id)."""
    files = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == files
    txts = [f for f in files if "depth_points" in f]
    assert txts and any(f.endswith("depth_points_fused.txt") for f in txts)
    for f in txts:
        a, b = _points(os.path.join(jdir, f)), _points(os.path.join(tdir, f))
        assert a, f"{f}: no depth points"
        common = set(a) & set(b)
        assert len(common) >= 0.98 * max(len(a), len(b)), f
        same = np.mean([abs(a[c] - b[c]) <= 1e-4 * a[c] for c in common])
        assert same >= 0.99, f"{f}: {same}"
    npys = [f for f in files if f.endswith(".npy")]
    assert npys
    for f in npys:
        a = np.load(os.path.join(jdir, f)).astype(np.float64)
        b = np.load(os.path.join(tdir, f)).astype(np.float64)
        assert b.shape == a.shape
        assert np.abs(b - a).sum() / np.abs(a).sum() < 1e-4, f
    skip = ("--out_path=",) + (("--num_devices=", "--coordinator=", "--num_processes=",
                                 "--process_id=") if launch_flags else ())
    flags = [[ln for ln in open(os.path.join(d, "run_flags.conf")).read().splitlines()
              if not ln.startswith(skip)] for d in (jdir, tdir)]
    assert flags[1] == flags[0]
