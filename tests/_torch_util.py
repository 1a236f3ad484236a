"""Shared helpers of the PyTorch port's tests (tests/test_torch_*.py).

The suite runs on several xdist workers per host, so each worker caps its
torch thread pool.  JAX and torch meet only through numpy arrays.
"""

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
