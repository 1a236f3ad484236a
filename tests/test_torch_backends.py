"""The voting backends of the PyTorch port beyond the kernel-engine specs,
against the JAX package on the CPU: `splat_sort`, the one-hot-matmul
("xla") engine's `hist:` specs and the `hist` / `hist_exact` names (run by
the port on the kernels' plain versions here), and the SMALL golden fixture
under the JAX package's off-TPU production spec.

Tolerance, as for the kernel-engine specs (`_assert_dsi_close`): DSI
relative L1 < 1e-2 and vote mass within 0.5 %.  The one-hot engine rounds
at the kernels' points, so most specs agree to the bit; `f32` bins with
bf16 taps on kernel A where the JAX engine keeps f32 ones (2^-9 a tap).
"""

import numpy as np
import pytest
import torch
from _torch_util import to_np
from test_golden_fast import SMALL_BUDGET
from test_torch_voting_hist import (  # noqa: F401  (rig_packets is a fixture)
    _assert_dsi_close, _vote_both, rig_packets)

import jax.numpy as jnp
from dvs_mcemvs_tpu.ops import voting as jvoting
from dvs_mcemvs_tpu.utils import golden as jgolden
from dvs_mcemvs_torch import convert, mapper as tmapper, pipeline as tpipe
from dvs_mcemvs_torch.ops import extract as tex, voting as tvoting, voting_hist as tvh
from dvs_mcemvs_torch.utils import golden as tgolden

# The one-hot engine's forms: the JAX package's two names, the flat merge,
# the ss2 flat merge of the off-TPU auto spec, int8 taps at ss2, f32
# histograms, no correction with custom padding.
XLA_SPECS = {
    "hist": "hist",
    "g4-seg4": "hist:g4,seg4",
    "g4-ss2-seg5": "hist:g4,ss2,seg5",
    "g8-ss2-i8": "hist:g8,ss2,i8",
    "g4-f32": "hist:g4,f32",
    "g4-nocorr-pad": "hist:g4,nocorr,px96,py16",
    "hist_exact": "hist_exact",
}


@pytest.mark.parametrize("spec", list(XLA_SPECS.values()), ids=list(XLA_SPECS))
def test_one_hot_engine_specs_match_jax(rig_packets, spec):
    packets, depths, vp, W, H = rig_packets
    for cam, p in enumerate(packets):
        got, want = _vote_both(spec, p, depths, vp, W, H)
        assert got.shape == (len(depths), H, W)
        _assert_dsi_close(got, want, f"{spec} camera {cam}")


def test_one_hot_engine_grid_is_not_aligned(rig_packets, monkeypatch):
    """Without "pl" the histogram grid is (H + 2 pad_y) ss x (W + 2 pad_x)
    ss, as the JAX one-hot engine bins it; with "pl" it is rounded up to
    64 rows and 128 columns."""
    packets, depths, vp, W, H = rig_packets
    seen = []
    real = tvh.bin_events

    def spy(hx, hy, w, *, hs, ws, **kw):
        seen.append((hs, ws))
        return real(hx, hy, w, hs=hs, ws=ws, **kw)

    monkeypatch.setattr(tvh, "bin_events", spy)
    p = convert.packets(packets[0], "cpu")
    for spec in ("hist:g8,ss2,px96,py16", "hist:g8,ss2,px96,py16,pl"):
        tvoting.resolve_backend(spec)(p, torch.as_tensor(depths), float(depths[0]), vp, W, H)
    assert seen == [((H + 32) * 2, (W + 192) * 2),
                    (-(-(H + 32) * 2 // 64) * 64, -(-(W + 192) * 2 // 128) * 128)]


def test_splat_sort_matches_jax(rig_packets):
    packets, depths, vp, W, H = rig_packets
    for cam, p in enumerate(packets):
        got, want = _vote_both("sort", p, depths, vp, W, H)
        _assert_dsi_close(got, want, f"sort camera {cam}")


def _heavy_packets(lib, K=64, P=1024, W=346, H=260, weight=24.0):
    """Packets whose plane block of 8 holds K*P*weight*8 > 2^23 of vote
    weight (12.6 M here) over a DAVIS-sized image, a few votes a voxel."""
    rng = np.random.default_rng(23)
    xy = np.stack([rng.uniform(0, W - 1, (K, P)), rng.uniform(0, H - 1, (K, P))], -1)
    centers = np.stack([np.linspace(0, 0.05, K), np.zeros(K), np.zeros(K)], -1)
    w = np.full((K, P), weight)
    if lib == "jax":
        return jvoting.WarpedPackets(jnp.asarray(xy, jnp.float32),
                                     jnp.asarray(centers, jnp.float32), jnp.ones(K, bool),
                                     jnp.asarray(w, jnp.float32))
    f32 = dict(dtype=torch.float32)
    return tvoting.WarpedPackets(torch.as_tensor(xy, **f32), torch.as_tensor(centers, **f32),
                                 torch.ones(K, dtype=torch.bool), torch.as_tensor(w, **f32))


def test_splat_sort_keeps_exact_sums_past_2_23():
    """A plane block whose running vote sum passes 2^23: the JAX package's
    float32 running-sum difference loses whole votes there (the fault this
    test records), the port's float64 one matches the exact scatter within
    1e-3 relative L1 and vote mass."""
    W, H = 346, 260
    depths = np.linspace(2.0, 2.4, 8)
    vp = (226.0, 226.0, 173.0, 130.0)
    args = (float(depths[0]), vp, W, H)
    d_t = torch.as_tensor(depths, dtype=torch.float32)
    exact = to_np(tvoting.splat_scatter(_heavy_packets("torch"), d_t, *args)).astype(np.float64)
    got = to_np(tvoting.splat_sort(_heavy_packets("torch"), d_t, *args)).astype(np.float64)
    jax_sort = np.asarray(jvoting.splat_sort(_heavy_packets("jax"),
                                             jnp.asarray(depths, jnp.float32), *args), np.float64)

    def l1(a):
        return np.abs(a - exact).sum() / np.abs(exact).sum()

    assert exact.sum() > 2**23
    assert l1(got) < 1e-3 and abs(got.sum() / exact.sum() - 1) < 1e-3, l1(got)
    assert l1(jax_sort) > 1e-3, f"the JAX float32 form kept its sums: {l1(jax_sort)}"


def test_small_golden_production_gate():
    """The port's process_1 + get_depth_map on golden.SMALL under the JAX
    package's off-TPU production spec (the one-hot engine's, which the JAX
    reference selects for this fixture) clears its production tier against
    the exact-scatter anchor (tests/test_golden_fast.py:100-102)."""
    mappers, events, trajs, scene, ts_rv = tgolden.build_golden_fixture(tgolden.SMALL,
                                                                         device="cpu")
    spec = jgolden.production_backend_spec(events, 1024, False, cfg=jgolden.SMALL)
    assert spec == "hist:g4,ss2,seg5"
    vopts = tpipe.VotingOptions(packet_size=1024, backend=spec, pad_policy="bucket")
    res = tpipe.process_1(mappers, events, trajs, ts_rv, stereo_fusion=2, vopts=vopts)
    dm = tmapper.get_depth_map(mappers[0], res.fused_dsi, tex.DepthMapOptions())
    got = tgolden.score(dm, res, scene, SMALL_BUDGET["confident_quantile"])
    b = SMALL_BUDGET["production"]
    assert got["within1"] >= b["within1"], got
    assert got["within2"] >= b["within2"], got
    assert got["median_planes"] <= b["median"], got
    assert max(got["cam_mass_rel"]) < SMALL_BUDGET["per_camera_mass_rel"], got
    assert got["gt_median_rel_err"] < b["gt_median_rel_err"], got
