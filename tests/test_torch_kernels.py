"""The port's kernel wrappers (their plain PyTorch versions, on the CPU)
against the JAX package's Pallas kernels in interpret mode.

Same numpy inputs through both.  Tolerance, bf16-level: every bin within
2e-2 of its own value plus 1e-3 of the largest bin, and the total mass
within 1e-3.  Both sides round taps and intermediates to bf16 at the same
points and accumulate in f32, but in another order: a sum that lands on
the other side of a bf16 rounding boundary moves its bin by one bf16 step
(2^-8 relative), and such steps compound at most twice (y stage, output).
"""

import numpy as np
import pytest
import torch
from _torch_util import to_np

import jax.numpy as jnp
from dvs_mcemvs_tpu.kernels import binning_pallas as jbin, resample_pallas as jres
from dvs_mcemvs_torch.kernels import binning as tbin, resample as tres

JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def assert_bf16_close(got, want):
    got = to_np(got).astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    excess = np.abs(got - want) - (2e-2 * np.abs(want) + 1e-3 * scale)
    assert excess.max() <= 0, f"bin off by {excess.max() / scale:.3g} of max over tolerance"
    assert abs(got.sum() - want.sum()) <= 1e-3 * abs(want.sum())


def _events(rng, G, E, hs, ws, binary):
    hx = rng.uniform(0, ws - 1, (G, E)).astype(np.float32)
    hy = rng.uniform(0, hs - 1, (G, E)).astype(np.float32)
    hx[:, :8] = ws - 1          # grid edges: the +1 tap falls off the grid
    hy[:, 8:16] = hs - 1
    hx[:, 16:24] = np.round(hx[:, 16:24])   # integer coordinates
    if binary:
        w = (rng.uniform(size=(G, E)) > 0.2).astype(np.float32)
    else:
        w = rng.uniform(0, 1, (G, E)).astype(np.float32)
        w[rng.uniform(size=(G, E)) < 0.2] = 0.0
    return hx, hy, w


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("binary", [False, True], ids=["weighted", "binary"])
def test_binning_matches_pallas(binary, out_dtype):
    rng = np.random.default_rng(10)
    G, E, hs, ws = 3, 2500, 128, 256
    hx, hy, w = _events(rng, G, E, hs, ws, binary)
    want = jbin.bin_events_pallas_windowed(
        jnp.asarray(hx), jnp.asarray(hy), jnp.asarray(w), hs=hs, ws=ws,
        binary_w=binary, out_dtype=JAX_DTYPES[out_dtype], interpret=True)
    got = tbin.bin_events(torch.as_tensor(hx), torch.as_tensor(hy), torch.as_tensor(w),
                          hs=hs, ws=ws, binary_w=binary, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (G, hs, ws)
    assert_bf16_close(got, np.asarray(want, np.float32))


def test_binning_rejects_fractional_binary_weights():
    w = torch.tensor([[1.0, 0.5]])
    with pytest.raises(ValueError, match="0 or 1"):
        tbin.bin_events(torch.zeros(1, 2), torch.zeros(1, 2), w, hs=4, ws=4,
                        binary_w=True)


def _maps(rng, shape, scale, shift):
    s = (scale + rng.uniform(-0.02, 0.02, shape)).astype(np.float32)
    t = (shift + rng.uniform(-3, 3, shape)).astype(np.float32)
    return s, t


# Map cases: (scale, translation y, translation x, out_h).  A single-strip
# map and one whose band is wider than the TPU kernel's strip (2/3 scale_min),
# which runs extra strips there; a band narrower than the CUDA kernel's
# 16 x 128 output tile (1.6); a scale whose bands at full size are wider
# than the CUDA kernel's staging buffer (0.3); translations that push each
# band past the source's bottom and left edges; an output height that is
# not a multiple of either kernel's tile.
MAP_CASES = {
    "in-band": (1.0, 4.0, 8.0, 48),
    "below-scale-min": (0.45, 4.0, 8.0, 48),
    "scale-1.6": (1.6, 4.0, 8.0, 48),
    "scale-0.3": (0.3, 4.0, 8.0, 48),
    "off-edge": (1.0, -30.0, 90.0, 48),
    "ragged-out-h": (1.0, 4.0, 8.0, 44),
}


@pytest.mark.parametrize("scale,shift_y,shift_x,Ho", list(MAP_CASES.values()),
                         ids=list(MAP_CASES))
@pytest.mark.parametrize("mode", ["sweep", "blocked", "src"])
def test_resample_sum_matches_pallas(mode, scale, shift_y, shift_x, Ho):
    rng = np.random.default_rng(11)
    N, K, hs, ws, Wo = 3, 2, 64, 256, 128
    scale_min = 2.0 / 3.0
    G = {"sweep": K, "blocked": N * K, "src": 5}[mode]
    hist = rng.uniform(0, 4, (G, hs, ws)).astype(np.float32)
    hist_j = jnp.asarray(hist, jnp.bfloat16)
    hist_t = torch.as_tensor(hist).to(torch.bfloat16)
    sy, ty = _maps(rng, (N, K), scale, shift_y)
    sx, tx = _maps(rng, (N, K), scale, shift_x)
    src = rng.integers(0, G, (N, K)).astype(np.int32) if mode == "src" else None
    out_dtype = torch.float32 if mode == "sweep" else torch.bfloat16
    want = jres.banded_resample_sum(
        hist_j, *(jnp.asarray(a) for a in (sy, ty, sx, tx)), out_h=Ho, out_w=Wo,
        blocked=mode == "blocked", scale_min=scale_min, interpret=True,
        src=None if src is None else jnp.asarray(src), out_dtype=JAX_DTYPES[out_dtype])
    got = tres.banded_resample_sum(
        hist_t, *(torch.as_tensor(a) for a in (sy, ty, sx, tx)), out_h=Ho, out_w=Wo,
        blocked=mode == "blocked", src=src, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    assert_bf16_close(got, np.asarray(want, np.float32))


def test_resample_sum_float32_sources():
    """f32 sources keep f32 taps and no intermediate rounding."""
    rng = np.random.default_rng(12)
    N, K, hs, ws, Ho, Wo = 2, 2, 64, 128, 40, 128
    hist = rng.uniform(0, 4, (K, hs, ws)).astype(np.float32)
    sy, ty = _maps(rng, (N, K), 1.0, 2.0)
    sx, tx = _maps(rng, (N, K), 1.0, 2.0)
    want = jres.banded_resample_sum(
        jnp.asarray(hist), *(jnp.asarray(a) for a in (sy, ty, sx, tx)), out_h=Ho,
        out_w=Wo, blocked=False, interpret=True)
    got = tres.banded_resample_sum(
        torch.as_tensor(hist), *(torch.as_tensor(a) for a in (sy, ty, sx, tx)),
        out_h=Ho, out_w=Wo, blocked=False)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


FANIN_CASES = {**{name: (2, *case) for name, case in MAP_CASES.items()},
               "K32": (32, 1.0, 4.0, 8.0, 16)}


@pytest.mark.parametrize("K,scale,shift_y,shift_x,Ho", list(FANIN_CASES.values()),
                         ids=list(FANIN_CASES))
def test_resample_fanin_matches_pallas(K, scale, shift_y, shift_x, Ho):
    """Ragged segments padded with clamped duplicate plane indices, as the
    plane sweep builds them.  Duplicate steps carry their own (random) maps
    here, so the port must also keep the TPU grid's last writer."""
    rng = np.random.default_rng(13)
    bounds = [0, 3, 5, 7] if K == 2 else [0, 2, 3]
    S = len(bounds) - 1
    M = max(bounds[s + 1] - bounds[s] for s in range(S))
    out_idx = np.stack([np.minimum(bounds[s] + np.arange(M), bounds[s + 1] - 1)
                        for s in range(S)]).astype(np.int32)
    hs, ws, Wo = (64, 256, 128) if K == 2 else (16, 128, 128)
    blocks = rng.uniform(0, 4, (S, K, hs, ws)).astype(np.float32)
    sy, ty = _maps(rng, (S, M, K), scale, shift_y)
    sx, tx = _maps(rng, (S, M, K), scale, shift_x)
    want = jres.banded_resample_fanin(
        jnp.asarray(blocks, jnp.bfloat16), *(jnp.asarray(a) for a in (sy, ty, sx, tx)),
        jnp.asarray(out_idx), n_out=bounds[-1], out_h=Ho, out_w=Wo,
        scale_min=2.0 / 3.0, interpret=True)
    got = tres.banded_resample_fanin(
        torch.as_tensor(blocks).to(torch.bfloat16),
        *(torch.as_tensor(a) for a in (sy, ty, sx, tx)), out_idx,
        n_out=bounds[-1], out_h=Ho, out_w=Wo)
    assert_bf16_close(got, np.asarray(want))


# int8 taps are summed exactly on both sides: the TPU kernels sum int32 per
# 1024-event block and add the blocks in f32, exact while a bin stays below
# 2^24 (about 1040 full-weight events; a bin here gathers a few), and the
# port sums in int64.  Both then multiply once by the same f32 constant and
# cast once, so the histograms agree bit for bit, bf16 output included.
@pytest.mark.parametrize("form,out_dtype", [("windowed", torch.bfloat16),
                                            ("windowed", torch.float32),
                                            ("dense", torch.float32)])
@pytest.mark.parametrize("binary", [False, True], ids=["weighted", "binary"])
def test_int8_binning_matches_pallas_exactly(form, out_dtype, binary):
    rng = np.random.default_rng(14)
    G, E = 3, 2500
    hs, ws = (128, 256) if form == "windowed" else (48, 256)
    hx, hy, w = _events(rng, G, E, hs, ws, binary)
    args = (jnp.asarray(hx), jnp.asarray(hy), jnp.asarray(w))
    if form == "windowed":
        want = jbin.bin_events_pallas_windowed(
            *args, hs=hs, ws=ws, int8=True, binary_w=binary,
            out_dtype=JAX_DTYPES[out_dtype], interpret=True)
    else:
        want = jbin.bin_events_pallas(*args, hs=hs, ws=ws, int8=True, interpret=True)
    got = tbin.bin_events(torch.as_tensor(hx), torch.as_tensor(hy), torch.as_tensor(w),
                          hs=hs, ws=ws, binary_w=binary, int8=True, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (G, hs, ws)
    np.testing.assert_array_equal(to_np(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("binary", [False, True], ids=["weighted", "binary"])
def test_dense_binning_matches_pallas(binary):
    """hs % 64 != 0: the JAX package's dense kernel, the same kernel here."""
    rng = np.random.default_rng(15)
    G, E, hs, ws = 2, 2000, 48, 256
    hx, hy, w = _events(rng, G, E, hs, ws, binary)
    want = jbin.bin_events_pallas(jnp.asarray(hx), jnp.asarray(hy), jnp.asarray(w),
                                  hs=hs, ws=ws, interpret=True)
    got = tbin.bin_events(torch.as_tensor(hx), torch.as_tensor(hy), torch.as_tensor(w),
                          hs=hs, ws=ws, binary_w=binary)
    assert_bf16_close(got, np.asarray(want))


@pytest.mark.parametrize("bad", [1.5, -0.25, float("nan")])
def test_int8_binning_rejects_weights_outside_unit_interval(bad):
    w = torch.tensor([[1.0, bad]])
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        tbin.bin_events(torch.zeros(1, 2), torch.zeros(1, 2), w, hs=4, ws=4, int8=True)


# The kernel's launch plan (kernels/binning.plan): bands of rows a group,
# one cluster of blocks a band, R rows of sums a block in shared memory.
PLAN_CASES = {
    "headline": (576, 896, 16384, False),
    "headline-int8": (576, 896, 16384, True),
    "dense": (552, 896, 16384, False),
    "ss2": (1152, 1792, 16384, False),
    "px96-py16": (512, 832, 16384, False),
    "tiny": (64, 128, 2500, False),
    "int8-u64": (576, 896, 300_000, True),
}


@pytest.mark.parametrize("hs,ws,E,int8", list(PLAN_CASES.values()), ids=list(PLAN_CASES))
def test_binning_plan_partitions_rows(hs, ws, E, int8):
    p = tbin.plan(hs, ws, E, int8)
    for spans, n in ((p.block_rows(), p.bands * p.cluster), (p.band_rows(), p.bands)):
        assert len(spans) == n
        assert spans[0][0] == 0 and spans[-1][1] == hs
        for (lo0, hi0), (lo1, hi1) in zip(spans, spans[1:]):
            assert lo0 <= hi0 == lo1 <= hi1      # in order, no gap, no overlap
    assert all(hi - lo <= p.rows for lo, hi in p.block_rows())
    assert 1 <= p.cluster <= 8
    acc_bytes = {"f32": 4, "u32": 4, "u64": 8}[p.acc]
    assert p.smem_bytes >= p.rows * ws * acc_bytes + tbin.STAGE_BYTES
    assert p.smem_bytes <= 232_448
    assert p.acc == ("f32" if not int8 else "u32" if E <= 266_288 else "u64")
    if p.acc == "u64":
        assert tbin.max_rows(ws, "u64") == tbin.max_rows(ws, "u32") // 2
        assert tbin.plan(hs, ws, 266_288, True).acc == "u32"
        assert tbin.plan(hs, ws, 266_289, True).acc == "u64"
    with pytest.raises(ValueError, match="ws <="):
        tbin.plan(hs, 60_000, E, int8)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_binning_bands_sum_to_whole(int8):
    """The plain version restricted to each band's (and each block's) rows,
    concatenated, is the whole histogram, with events on every edge."""
    rng = np.random.default_rng(16)
    G, E, hs, ws = 2, 3000, 64, 128
    # Five rows a block at most, four blocks a cluster: four bands.
    p = tbin.plan(hs, ws, E, int8, cluster=4, smem_limit=tbin.STAGE_BYTES + 5 * ws * 4)
    assert p.bands > 1 and p.cluster == 4
    hx, hy, w = _events(rng, G, E, hs, ws, binary=False)
    edges = [lo for lo, _ in p.block_rows() if 0 < lo < hs]
    on_edges = np.array([y for lo in edges for y in (lo - 1, lo - 0.5, lo)] + [hs - 1],
                        np.float32)
    hy[:, 100:100 + on_edges.size] = on_edges
    hx[:, 100:100 + on_edges.size] = rng.uniform(0, ws - 1, on_edges.size)
    w[:, 100:100 + on_edges.size] = 1.0
    args = [torch.as_tensor(a) for a in (hx, hy, w)]
    plain = tbin.bin_events_int8_reference if int8 else tbin.bin_events_reference
    whole = plain(*args, hs, ws)
    for spans in (p.band_rows(), p.block_rows()):
        parts = torch.cat([plain(*args, hs, ws, rows=s) for s in spans], dim=1)
        assert parts.shape == whole.shape
        if int8:
            assert torch.equal(parts, whole)
        else:
            torch.testing.assert_close(parts, whole, rtol=1e-6, atol=0)


@pytest.mark.parametrize("wrapper", ["bin_events", "banded_resample_sum"])
def test_wrappers_take_more_than_65535_items(wrapper):
    """Neither wrapper caps a call at 65,535 groups or items (the kernels
    put them on grid x): 70,000 groups of 4 events on a 4 x 8 grid, then
    70,000 identity resamples of those planes, against exact sums.  Events
    on bin centres make every tap 0 or 1, so the sums are counts."""
    rng = np.random.default_rng(65536)
    G, E, hs, ws = 70_000, 4, 4, 8
    hx = rng.integers(0, ws, (G, E)).astype(np.float32)
    hy = rng.integers(0, hs, (G, E)).astype(np.float32)
    w = (rng.uniform(size=(G, E)) > 0.25).astype(np.float32)
    want = np.zeros((G, hs, ws), np.float32)
    np.add.at(want, (np.repeat(np.arange(G), E), hy.reshape(-1).astype(int),
                     hx.reshape(-1).astype(int)), w.reshape(-1))
    hist = tbin.bin_events(torch.as_tensor(hx), torch.as_tensor(hy), torch.as_tensor(w),
                           hs=hs, ws=ws, binary_w=True)
    if wrapper == "bin_events":
        np.testing.assert_array_equal(to_np(hist), want)
        return
    ones, zeros = torch.ones(G, 1), torch.zeros(G, 1)
    out = tres.banded_resample_sum(hist, ones, zeros, ones, zeros, out_h=hs, out_w=ws,
                                   blocked=True)
    np.testing.assert_array_equal(to_np(out), want)
