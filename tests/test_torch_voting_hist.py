"""Histogram voting of the PyTorch port against the JAX package on the CPU.

The small rig of `__graft_entry__._fixture` (64x48, Z=16): the JAX package
warps the events, both packages vote the same packets.  The JAX side runs
its Pallas kernels in interpret mode (as its own tests do), the port its
kernels' plain versions.  Tolerance: DSI relative L1 < 1e-2 and per-camera
vote mass within 0.5 % (the golden budget's `per_camera_mass_rel`).  Both
vote through bf16 (or f32) histograms and merge levels, with bf16 or int8
binning taps, rounded at the same points; what differs is f32 summation
order, which flips a bf16 rounding now and then (one 2^-8 step on a few
voxels), far below 1e-2 in L1.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch
from _torch_util import to_np

import jax.numpy as jnp
from dvs_mcemvs_tpu.ops import camera as jcam, voting as jvoting, voting_hist as jvh
from dvs_mcemvs_torch import convert
from dvs_mcemvs_torch.ops import voting as tvoting, voting_hist as tvh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _graft_fixture():
    spec = importlib.util.spec_from_file_location(
        "_graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._fixture()


@pytest.fixture(scope="module")
def rig_packets():
    """JAX-warped packets of both cameras: camera 0 without per-event
    weights (0/1 binning path), camera 1 padded with zero-weight events."""
    mappers, events, trajs, T_rv_w, packet_size = _graft_fixture()
    m = mappers[0]
    depths = m.depth_vec.depths()
    out = []
    for cam, (mp, ev, tr) in enumerate(zip(mappers, events, trajs)):
        x, y, t = ev.x, ev.y, ev.t.astype(np.float32)
        w = None
        if cam == 1:
            cap = -(-ev.num // packet_size) * packet_size
            x, y = np.pad(x, (0, cap - ev.num)), np.pad(y, (0, cap - ev.num))
            t = np.pad(t, (0, cap - ev.num), mode="edge")
            w = np.zeros(cap, np.float32)
            w[:ev.num] = 1.0
        out.append(jvoting.warp_events_to_z0(
            jnp.asarray(x, jnp.int32), jnp.asarray(y, jnp.int32), jnp.asarray(t), tr,
            T_rv_w, None, jnp.asarray(mp.cam.P, jnp.float32),
            jnp.asarray(np.linalg.inv(mp.vcam.P), jnp.float32),
            z0=float(depths[0]), width=m.width, packet_size=packet_size,
            rect_params=jcam.rect_static(mp.cam), full=w is not None,
            ev_weight=None if w is None else jnp.asarray(w)))
    vp = (float(m.vcam.fx), float(m.vcam.fy), float(m.vcam.cx), float(m.vcam.cy))
    return out, depths, vp, m.width, m.height


# Every form of the kernel-engine grammar: the butterfly at radix 4 and 8,
# int8 binning, the flat merge (also at a segment count that is not a power
# of two), the non-segmented sweep, supersampling, f32 histograms, no sweep
# correction with custom padding, and segment counts above the plane count.
SPECS = {
    "radix4": "hist:g2,seg4,bf,pl",
    "radix8-fanin-merge": "hist:g2,seg8,bf,pl",
    "i8": "hist:g2,seg4,bf,i8,pl",
    "flat": "hist:g2,seg4,pl",
    "sweep": "hist:g2,pl",
    "ss2": "hist:g2,ss2,seg4,bf,pl",
    "f32": "hist:g2,seg4,bf,f32,pl",
    "nocorr-pad": "hist:g2,seg4,bf,nocorr,px96,py16,pl",
    "flat-seg5": "hist:g2,seg5,pl",
    # More segments than the rig's 16 planes: the segment clamp.
    "clamp-butterfly": "hist:g2,seg32,bf,pl",
    "clamp-flat": "hist:g2,seg20,pl",
    # Specs the first slice of the port refused.
    "g4-ss2-radix8": "hist:g4,ss2,seg8,bf,pl",
    "g4-flat-seg8": "hist:g4,seg8,pl",
    "g4-sweep-bf": "hist:g4,bf,pl",
    "g4-radix8-nocorr": "hist:g4,seg8,bf,pl,nocorr",
    "g4-radix8-i8": "hist:g4,seg8,bf,pl,i8",
}


def _assert_dsi_close(got, want, what):
    got, want = got.astype(np.float64), want.astype(np.float64)
    assert got.shape == want.shape, what
    l1 = np.abs(got - want).sum() / np.abs(want).sum()
    assert l1 < 1e-2, f"{what}: relative L1 {l1:.3g}"
    mass = got.sum() / want.sum() - 1
    assert abs(mass) < 0.005, f"{what}: mass off by {mass:.3g}"


def _vote_both(spec, p, depths, vp, W, H):
    want = np.asarray(jvoting.resolve_backend(spec)(
        p, jnp.asarray(depths), float(depths[0]), vp, W, H))
    got = to_np(tvoting.resolve_backend(spec)(
        convert.packets(p, "cpu"), torch.as_tensor(depths), float(depths[0]), vp, W, H))
    return got, want


@pytest.mark.parametrize("spec", list(SPECS.values()), ids=list(SPECS))
def test_splat_hist_matches_jax(rig_packets, spec):
    packets, depths, vp, W, H = rig_packets
    for cam, p in enumerate(packets):
        got, want = _vote_both(spec, p, depths, vp, W, H)
        assert got.shape == (len(depths), H, W)
        _assert_dsi_close(got, want, f"camera {cam}")


@pytest.mark.parametrize("spec", ["hist:g2,seg4,bf,pl", "hist:g2,seg4,bf,i8,pl"],
                         ids=["bf16", "i8"])
def test_splat_hist_fractional_weights_match_jax(rig_packets, spec):
    """Fractional per-event weights: the binning stage's non-binary path
    (weights ride into the y tap before its rounding)."""
    packets, depths, vp, W, H = rig_packets
    p = packets[0]
    w = np.random.default_rng(16).uniform(0.05, 1.0, p.xy_z0.shape[:2]).astype(np.float32)
    got, want = _vote_both(spec, p._replace(weight=jnp.asarray(w)), depths, vp, W, H)
    _assert_dsi_close(got, want, "fractional weights")


def test_group_histograms_match_jax(rig_packets):
    """The binning stage alone, with the sweep correction, in bf16."""
    packets, depths, vp, W, H = rig_packets
    hs, ws = 128, 384
    u = 1.0 / depths
    u_mid = 0.5 * (u.min() + u.max())
    corr = (float(depths[0]), *vp, np.float32(u_mid))
    for p in packets:
        jh, jc = jvh.build_group_histograms(
            p, 2, hs, ws, 128, 32, 1, correction=corr, engine="pallas",
            out_dtype=jnp.bfloat16)
        th, tc = tvh.build_group_histograms(
            convert.packets(p, "cpu"), 2, hs, ws, 128, 32, 1,
            correction=(*corr[:5], torch.tensor(u_mid, dtype=torch.float32)),
            out_dtype=torch.bfloat16)
        np.testing.assert_allclose(to_np(tc), np.asarray(jc), rtol=1e-5, atol=1e-6)
        want = np.asarray(jh, np.float64)
        got = to_np(th).astype(np.float64)
        assert np.abs(got - want).sum() / np.abs(want).sum() < 1e-2
        assert abs(got.sum() / want.sum() - 1) < 1e-3


@pytest.mark.parametrize("travel,n_pk,fx,dmin,dmax,dim_z", [
    (0.5, 1024, 576.0, 2.0, 40.0, 100),     # the headline workload
    (0.393, 256, 555.0, 4.0, 24.0, 100),    # golden BENCH16
    (0.39, 64, 277.5, 4.0, 24.0, 50),       # golden SMALL
    (0.4, 40, 51.2, 1.0, 4.0, 16),          # the graft rig
    (0.0, 1, 100.0, 1.0, 2.0, 5),           # degenerate
])
def test_auto_spec_helpers_match_jax(travel, n_pk, fx, dmin, dmax, dim_z):
    assert tvh.auto_backend_spec(travel, n_pk, fx, dmin, dmax, dim_z) \
        == jvh.auto_backend_spec(travel, n_pk, fx, dmin, dmax, dim_z, use_pallas=True)
    depths = np.linspace(dmin, dmax, dim_z)
    for s in (2, 4, 8, 16, 32):
        assert tvh._butterfly_radii(s) == jvh._butterfly_radii(s)
        if s <= dim_z:
            assert tvh.segment_bounds_equal_u(depths, s) == jvh.segment_bounds_equal_u(depths, s)


def test_headline_spec_is_literal():
    assert tvh.auto_backend_spec(0.5, 1024, 576.0, 2.0, 40.0, 100) == "hist:g16,seg16,bf,pl"


# Specs the port does not run: the butterfly merge without the Pallas
# engine ("pl"), as in the JAX package, and unknown tokens.  Each raises when
# it is resolved or when it votes.
@pytest.mark.parametrize("spec", ["hist:g4,seg8,bf", "hist:g4,seg8,bf,pl,fast"])
def test_resolve_backend_refuses_unported_specs(rig_packets, spec):
    packets, depths, vp, W, H = rig_packets
    with pytest.raises(ValueError):
        tvoting.resolve_backend(spec)(convert.packets(packets[0], "cpu"),
                                      torch.as_tensor(depths), float(depths[0]), vp, W, H)


@pytest.mark.parametrize("backend", ["scatter", "hist:g4,seg4,bf,pl"])
def test_vote_dsi_matches_jax(rig_packets, backend):
    """The one-call voting entry: z0 from the first plane depth, the
    backend resolved from its spec.  Tolerance: relative L1 < 1e-5 under
    the exact scatter (float32 scatter-add order), and this file's budget
    under the histogram spec."""
    packets, depths, vp, W, H = rig_packets
    mp = _graft_fixture()[0][0]
    vcam = convert.camera(mp.vcam)
    for cam, p in enumerate(packets):
        want = np.asarray(jvoting.vote_dsi(p, jnp.asarray(depths), mp.vcam, backend=backend),
                          np.float64)
        got = to_np(tvoting.vote_dsi(convert.packets(p, "cpu"), depths, vcam,
                                     backend=backend)).astype(np.float64)
        assert got.shape == (len(depths), H, W)
        if backend == "scatter":
            assert np.abs(got - want).sum() / np.abs(want).sum() < 1e-5, f"camera {cam}"
        else:
            _assert_dsi_close(got, want, f"camera {cam}")
