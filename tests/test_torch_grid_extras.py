"""The grid operations of the PyTorch port that no pipeline path runs,
against the JAX package on the CPU: the two-grid fusions and the
out-of-place accumulator, collapse_min, the grid statistics, the
local-focus harmonic mean and the 3D filters.

Same numpy inputs (a seed, a small (Z, H, W) grid) through both packages.
Tolerances:
  - elementwise ops: rtol 1e-6, atol 1e-7 (one float32 rounding apart at
    most; the cube root of a negative mean keeps its sign in both);
  - collapse_min: equal values and indices (ties to the lowest index);
  - statistics and the local-focus transforms: relative 1e-5 (float32
    reductions and blur sums in another order);
  - 3D filters: max |port - JAX| <= 1e-5 max |input| (diffuse at sigma 1
    runs 12 Euler steps); Moran's I: absolute 1e-4.
"""

import numpy as np
import pytest
import torch
from _torch_util import assert_rel_close, to_np

import jax.numpy as jnp
from dvs_mcemvs_tpu.ops import grid as jgrid
from dvs_mcemvs_torch.ops import grid as tgrid

SHAPE = (6, 14, 18)


def _grids(seed, positive=False):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=SHAPE).astype(np.float32)
    b = rng.normal(size=SHAPE).astype(np.float32)
    if positive:
        a, b = np.abs(a) * 4, np.abs(b) * 4
    return a, b


ELEMENTWISE = {
    "fuse_add": lambda m, a, b: m.fuse_add(a, b),
    "fuse_subtract": lambda m, a, b: m.fuse_subtract(a, b),
    "fuse_ratio": lambda m, a, b: m.fuse_ratio(a, b),
    "fuse_ratio-eps": lambda m, a, b: m.fuse_ratio(a, b, eps=0.5),
    "fuse_quadratic_mean": lambda m, a, b: m.fuse_quadratic_mean(a, b),
    "fuse_cubic_mean": lambda m, a, b: m.fuse_cubic_mean(a, b),
    "add_inverse": lambda m, a, b: m.add_inverse(a, b),
    "add_inverse-eps": lambda m, a, b: m.add_inverse(a, b, eps=0.25),
}


@pytest.mark.parametrize("op", list(ELEMENTWISE), ids=list(ELEMENTWISE))
def test_elementwise_ops_match_jax(op):
    """Signed inputs: the ratio's |g2|, the cube root of negative means and
    the accumulator's poles all show."""
    a, b = _grids(1)
    want = np.asarray(ELEMENTWISE[op](jgrid, jnp.asarray(a), jnp.asarray(b)))
    got = to_np(ELEMENTWISE[op](tgrid, torch.as_tensor(a), torch.as_tensor(b)))
    assert got.dtype == np.float32 and got.shape == want.shape
    if op == "fuse_cubic_mean":
        assert (want < 0).any() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_add_inverse_is_out_of_place():
    a, b = _grids(2, positive=True)
    acc = torch.as_tensor(a)
    out = tgrid.add_inverse(acc, torch.as_tensor(b))
    np.testing.assert_array_equal(to_np(acc), a)
    np.testing.assert_array_equal(to_np(out), to_np(tgrid.add_inverse_(acc.clone(),
                                                                         torch.as_tensor(b))))


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_collapse_min_matches_jax(ties):
    """Equal values and indices; integer grids make ties along depth, which
    go to the lowest index in both."""
    rng = np.random.default_rng(3)
    if ties:
        d = rng.integers(0, 3, SHAPE).astype(np.float32)
    else:
        d = rng.normal(size=SHAPE).astype(np.float32)
    jc, ji = jgrid.collapse_min(jnp.asarray(d))
    tc, ti = tgrid.collapse_min(torch.as_tensor(d))
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(to_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(to_np(ti), np.asarray(ji))


STATS = {
    "mean_square": lambda m, d: (m.mean_square(d),),
    "min_max": lambda m, d: m.min_max(d),
    "mean_std": lambda m, d: m.mean_std(d),
}


@pytest.mark.parametrize("stat", list(STATS), ids=list(STATS))
def test_statistics_match_jax(stat):
    """mean_std's deviation is the population one (no Bessel correction)."""
    d = (np.random.default_rng(4).normal(size=SHAPE) * 3 + 1).astype(np.float32)
    want = STATS[stat](jgrid, jnp.asarray(d))
    got = STATS[stat](tgrid, torch.as_tensor(d))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    if stat == "mean_std":
        np.testing.assert_allclose(float(got[1]), d.astype(np.float64).std(ddof=0),
                                   rtol=1e-5)


FOCUS = {
    "local_focus-std": lambda m, a, b: m.local_focus_in_place(a, 0),
    "local_focus-ms": lambda m, a, b: m.local_focus_in_place(a, 1),
    "local_focus-std-sigma1": lambda m, a, b: m.local_focus_in_place(a, 0, sigma=1.0),
    "hm_local_focus-std": lambda m, a, b: m.fuse_harmonic_mean_of_local_focus(a, b, 0),
    "hm_local_focus-ms": lambda m, a, b: m.fuse_harmonic_mean_of_local_focus(a, b, 1),
    "hm_local_focus-eps": lambda m, a, b: m.fuse_harmonic_mean_of_local_focus(
        a, b, 0, sigma=0.8, eps=0.3),
}


@pytest.mark.parametrize("op", list(FOCUS), ids=list(FOCUS))
def test_local_focus_matches_jax(op):
    a, b = _grids(5, positive=True)
    want = FOCUS[op](jgrid, jnp.asarray(a), jnp.asarray(b))
    got = FOCUS[op](tgrid, torch.as_tensor(a), torch.as_tensor(b))
    assert_rel_close(got, want, 1e-5, op)


FILTERS = {
    "laplacian3d": lambda m, d: m.laplacian3d(d),
    "diffuse-sigma1": lambda m, d: m.diffuse(d, 1.0),
    "diffuse-sigma0.3": lambda m, d: m.diffuse(d, 0.3),
    "diffuse-sigma0": lambda m, d: m.diffuse(d, 0.0),
    "gaussian_blur_3d-sigma1": lambda m, d: m.gaussian_blur_3d(d, 1.0),
    "gaussian_blur_3d-sigma0.5": lambda m, d: m.gaussian_blur_3d(d, 0.5),
}


@pytest.mark.parametrize("op", list(FILTERS), ids=list(FILTERS))
def test_3d_filters_match_jax(op):
    d = (np.random.default_rng(6).normal(size=SHAPE) * 5).astype(np.float32)
    want = np.asarray(FILTERS[op](jgrid, jnp.asarray(d)))
    got = to_np(FILTERS[op](tgrid, torch.as_tensor(d)))
    assert got.shape == d.shape and got.dtype == np.float32
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(d).max()), op
    if op == "diffuse-sigma0":
        np.testing.assert_array_equal(got, d)


@pytest.mark.parametrize("sigma", [1.0, 0.5, 0.1], ids=["1", "0.5", "clamped"])
def test_moran_index_matches_jax(sigma):
    """A smooth grid (high I) and sigma below the 0.2 clamp."""
    rng = np.random.default_rng(7)
    d = rng.normal(size=SHAPE).astype(np.float32)
    d = np.asarray(jgrid.gaussian_blur_3d(jnp.asarray(d), 1.5)) + 0.1 * d
    want = float(jgrid.moran_index_gaussian_weights(jnp.asarray(d), sigma))
    got = float(tgrid.moran_index_gaussian_weights(torch.as_tensor(d), sigma))
    assert abs(got - want) <= 1e-4, (got, want)
