"""Fusion, Z-collapse and depth extraction of the PyTorch port against the
JAX package, on one shared numpy DSI.

The collapse and the extraction chain are integer-valued after the
confidence quantization, and both packages evaluate the same f32 formulas
in the same order, so indices, confidence and mask must be exactly equal and
depth within 1 ulp (the closed-form index -> depth fold).  Fusion and the
2D filters are elementwise f32 formulas: 1e-6 relative (a few ulps where
transcendental functions or three-term means round differently).
"""

import numpy as np
import pytest
import torch
from _torch_util import to_np

import jax.numpy as jnp
from dvs_mcemvs_tpu.ops import depth_vector as jdv, extract as jex, grid as jgrid
from dvs_mcemvs_torch.ops import depth_vector as tdv, extract as tex, grid as tgrid

Z, H, W = 24, 40, 56


def _dsi(kind: str) -> np.ndarray:
    rng = np.random.default_rng(20)
    if kind == "ties":   # few distinct values: many argmax ties
        return (rng.integers(0, 5, (Z, H, W)) * 0.5).astype(np.float32)
    # A depth ramp of vote peaks over noise, as a voted DSI looks.
    z_true = (np.linspace(2, Z - 3, W)[None, :] + 2 * np.sin(np.arange(H))[:, None])
    zz = np.arange(Z)[:, None, None]
    peak = 40 * np.exp(-0.5 * (zz - z_true[None]) ** 2)
    return (peak + rng.gamma(2.0, 3.0, (Z, H, W))).astype(np.float32)


@pytest.mark.parametrize("kind", ["peaks", "ties"])
def test_collapse_max_exact(kind):
    dsi = _dsi(kind)
    jc, ji = jgrid.collapse_max(jnp.asarray(dsi))
    tc, ti = tgrid.collapse_max(torch.as_tensor(dsi))
    np.testing.assert_array_equal(to_np(ti), np.asarray(ji))
    np.testing.assert_array_equal(to_np(tc), np.asarray(jc))
    assert ti.dtype == torch.int32


OPTIONS = [
    jex.DepthMapOptions(),
    jex.DepthMapOptions(max_confidence=300.0),
    jex.DepthMapOptions(adaptive_threshold_kernel_size=3, adaptive_threshold_c=2.0,
                        median_filter_size=3),
    jex.DepthMapOptions(adaptive_threshold_kernel_size=7, adaptive_threshold_c=-1.5,
                        median_filter_size=7),
]


@pytest.mark.parametrize("kind", ["peaks", "ties"])
@pytest.mark.parametrize("opt_i", range(len(OPTIONS)))
@pytest.mark.parametrize("sampling", [jdv.INVERSE, jdv.LINEAR])
def test_extraction_chain_exact(kind, opt_i, sampling):
    dsi = _dsi(kind)
    jopt = OPTIONS[opt_i]
    topt = tex.DepthMapOptions(**{f: getattr(jopt, f) for f in jopt.__dataclass_fields__})
    want = jex.get_depth_map_from_dsi(jnp.asarray(dsi), jdv.DepthVector(sampling, 4.0, 24.0, Z),
                                      jopt)
    got = tex.get_depth_map_from_dsi(torch.as_tensor(dsi), tdv.DepthVector(sampling, 4.0, 24.0, Z),
                                     topt)
    np.testing.assert_array_equal(to_np(got.depth_indices), np.asarray(want.depth_indices))
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))
    np.testing.assert_array_equal(to_np(got.confidence), np.asarray(want.confidence))
    np.testing.assert_array_max_ulp(to_np(got.depth), np.asarray(want.depth), maxulp=1)
    assert got.mask.dtype == torch.uint8
    if kind == "peaks":   # the threshold keeps some pixels, not all
        assert 0 < int(got.mask.sum()) < H * W


@pytest.mark.parametrize("method", [jgrid.FUSE_MIN, jgrid.FUSE_HM, jgrid.FUSE_GM,
                                    jgrid.FUSE_AM, jgrid.FUSE_RMS, jgrid.FUSE_MAX])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_fusion_matches_jax(method, n):
    rng = np.random.default_rng(21)
    grids = [rng.gamma(2.0, 2.0, (4, 8, 8)).astype(np.float32) for _ in range(n)]
    want = np.asarray(jgrid.fuse_many([jnp.asarray(g) for g in grids], method))
    got = to_np(tgrid.fuse_many([torch.as_tensor(g) for g in grids], method))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if n == 2:
        pair = to_np(tgrid.fuse_pair(*(torch.as_tensor(g) for g in grids), method))
        np.testing.assert_allclose(
            pair, np.asarray(jgrid.fuse_pair(*(jnp.asarray(g) for g in grids), method)),
            rtol=1e-6, atol=0)


@pytest.mark.parametrize("border", ["reflect", "reflect101", "replicate", "zero"])
def test_conv2d_same_borders(border):
    rng = np.random.default_rng(22)
    img = rng.uniform(0, 255, (2, 9, 11)).astype(np.float32)
    k = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    k[2, 1] = 0.0
    want = np.asarray(jgrid.conv2d_same(jnp.asarray(img), k, border))
    got = to_np(tgrid.conv2d_same(torch.as_tensor(img), k, border))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    g = jgrid.gaussian_kernel_1d(5, -1.0)
    np.testing.assert_array_equal(tgrid.gaussian_kernel_1d(5, -1.0), g)
    np.testing.assert_allclose(
        to_np(tgrid.sep_conv2d_same(torch.as_tensor(img), g, g, border)),
        np.asarray(jgrid.sep_conv2d_same(jnp.asarray(img), g, g, border)), rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("name,args", [
    ("gaussian_blur", (0.5,)), ("gaussian_blur", (0.8,)), ("sobel_grad_mag_sq", ()),
    ("laplacian5", ()), ("box_mean", (2,)),
])
def test_2d_filters_match_jax(name, args):
    img = _dsi("peaks")[:4]
    want = np.asarray(getattr(jgrid, name)(jnp.asarray(img), *args))
    got = to_np(getattr(tgrid, name)(torch.as_tensor(img), *args))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * float(np.abs(want).max()))
    for sigma in (0.5, 0.8, 1.3):
        assert tgrid.gaussian_ksize_from_sigma(sigma) == jgrid.gaussian_ksize_from_sigma(sigma)


@pytest.mark.parametrize("method", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["peaks", "ties"])
def test_focus_collapse_matches_jax(method, kind):
    """Confidence within rtol 1e-5, atol 1e-6; depth indices equal but where
    the best two focus values are within 1e-5 of each other (a near-tie the
    f32 rounding of the filters may flip), at most 0.1 % of the pixels."""
    dsi = _dsi(kind)
    jc, ji = jgrid.collapse(jnp.asarray(dsi), method)
    tc, ti = tgrid.collapse(torch.as_tensor(dsi), method)
    np.testing.assert_allclose(to_np(tc), np.asarray(jc), rtol=1e-5, atol=1e-6)
    assert ti.dtype == torch.int32
    differ = to_np(ti) != np.asarray(ji)
    if differ.any():
        focus = {0: lambda d: np.maximum(
                     np.asarray(jgrid.gaussian_blur(d * d, 0.5))
                     - np.asarray(jgrid.gaussian_blur(d, 0.5)) ** 2, 0),
                 1: lambda d: np.asarray(jgrid.gaussian_blur(d * d, 0.5)),
                 2: lambda d: np.asarray(jgrid.box_mean(jgrid.sobel_grad_mag_sq(d), 2)),
                 3: lambda d: np.asarray(jgrid.laplacian5(d)) ** 2,
                 4: lambda d: np.abs(np.asarray(jgrid.gaussian_blur(d, 0.5))
                                     - np.asarray(jgrid.gaussian_blur(d, 0.8)))}[method]
        top2 = np.sort(focus(jnp.asarray(dsi)), axis=0)[-2:]
        near_tie = top2[1] - top2[0] <= 1e-5 * np.abs(top2[1])
        assert near_tie[differ].all()
        assert differ.mean() <= 1e-3


@pytest.mark.parametrize("method", [0, 2, 4])
def test_extraction_chain_with_focus_collapse_matches_jax(method):
    dsi = _dsi("peaks")
    jopt = jex.DepthMapOptions(collapse_method=method)
    topt = tex.DepthMapOptions(collapse_method=method)
    want = jex.get_depth_map_from_dsi(jnp.asarray(dsi),
                                      jdv.DepthVector(jdv.INVERSE, 4.0, 24.0, Z), jopt)
    got = tex.get_depth_map_from_dsi(torch.as_tensor(dsi),
                                     tdv.DepthVector(tdv.INVERSE, 4.0, 24.0, Z), topt)
    np.testing.assert_array_equal(to_np(got.depth_indices), np.asarray(want.depth_indices))
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))


@pytest.mark.parametrize("levels", [300, None])
@pytest.mark.parametrize("patch", [3, 5, 9])
def test_median_above_256_levels_matches_jax(levels, patch):
    """The gather + sort median (more than 256 levels, or any float input):
    exact."""
    rng = np.random.default_rng(24)
    img = rng.integers(0, 300, (H, W)).astype(np.float32)
    if levels is None:
        img += rng.uniform(0, 1, img.shape).astype(np.float32)
    mask = (rng.uniform(size=(H, W)) > 0.6).astype(np.uint8)
    want = np.asarray(jex.masked_median_filter(jnp.asarray(img), jnp.asarray(mask), patch, levels))
    got = to_np(tex.masked_median_filter(torch.as_tensor(img), torch.as_tensor(mask), patch,
                                         levels))
    np.testing.assert_array_equal(got, want)
    want_u8 = np.asarray(jex.masked_median_filter_u8(jnp.asarray(img), jnp.asarray(mask), patch,
                                                     levels=300))
    got_u8 = tex.masked_median_filter_u8(torch.as_tensor(img), torch.as_tensor(mask), patch,
                                         levels=300)
    assert got_u8.dtype == torch.int32
    np.testing.assert_array_equal(to_np(got_u8), want_u8)


def test_extraction_chain_above_256_planes_matches_jax():
    """A 300-plane DSI: the extraction's median takes the sort path."""
    rng = np.random.default_rng(25)
    z = 300
    z_true = np.linspace(10, z - 10, W)[None, :] + 3 * np.sin(np.arange(H))[:, None]
    zz = np.arange(z)[:, None, None]
    dsi = (40 * np.exp(-0.5 * ((zz - z_true[None]) / 4) ** 2)
           + rng.gamma(2.0, 3.0, (z, H, W))).astype(np.float32)
    want = jex.get_depth_map_from_dsi(jnp.asarray(dsi),
                                      jdv.DepthVector(jdv.INVERSE, 1.0, 6.5, z),
                                      jex.DepthMapOptions())
    got = tex.get_depth_map_from_dsi(torch.as_tensor(dsi),
                                     tdv.DepthVector(tdv.INVERSE, 1.0, 6.5, z),
                                     tex.DepthMapOptions())
    np.testing.assert_array_equal(to_np(got.depth_indices), np.asarray(want.depth_indices))
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))
    assert int(to_np(got.depth_indices).max()) > 256
