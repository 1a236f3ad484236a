"""The port's hist backends on the sharded path against the JAX package's,
on the CPU: `splat_hist`'s sharded arguments (`corr_u_mid`,
`weights_binary`, `seg_bounds`) on the small fixture of
tests/test_torch_voting_hist.py, within that file's tolerance (relative L1
< 1e-2, vote mass within 0.5 %); and the sharded step and sharded voting
step under the exact-grouping `hist:g1,ss2` on 4 gloo CPU ranks, meshes
(4, 1), (1, 4), (2, 2), against the JAX sharded step and the port's single
device (tolerances in tests/_torch_sharded.py).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_util import to_np

import _torch_sharded as S

from dvs_mcemvs_tpu.ops import camera as jcam, voting as jvoting, voting_hist as jvh
from dvs_mcemvs_torch import convert
from dvs_mcemvs_torch.ops import voting as tvoting, voting_hist as tvh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def small_packets():
    spec = importlib.util.spec_from_file_location(
        "_graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mappers, events, trajs, T_rv_w, packet_size = mod._fixture()
    m = mappers[1]
    depths = m.depth_vec.depths()
    ev = events[1]
    # Padded with zero-weight events: explicit 0/1 weights, as the sharded
    # step's padding mask.
    cap = -(-ev.num // packet_size) * packet_size
    w = np.zeros(cap, np.float32)
    w[:ev.num] = 1.0
    p = jvoting.warp_events_to_z0(
        jnp.asarray(np.pad(ev.x, (0, cap - ev.num)), jnp.int32),
        jnp.asarray(np.pad(ev.y, (0, cap - ev.num)), jnp.int32),
        jnp.asarray(np.pad(ev.t.astype(np.float32), (0, cap - ev.num), mode="edge")),
        trajs[1], T_rv_w, None, jnp.asarray(m.cam.P, jnp.float32),
        jnp.asarray(np.linalg.inv(m.vcam.P), jnp.float32), z0=float(depths[0]),
        width=m.width, packet_size=packet_size, rect_params=jcam.rect_static(m.cam),
        full=True, ev_weight=jnp.asarray(w))
    vp = (float(m.vcam.fx), float(m.vcam.fy), float(m.vcam.cx), float(m.vcam.cy))
    return p, depths, vp, m.width, m.height


# (planes voted, kwargs): a plane block with the whole sweep's correction
# midpoint ("global", as the sharded step passes it), the 0/1 weights
# asserted (f32 and int8 taps), explicit bounds with and without an empty
# segment (butterfly at radix 4 and 8, flat), and bounds dropped by the
# segment clamp.
SHARD_CASES = {
    "corr-u-mid-block": (slice(4, 8), dict(segments=4, merge_mode="butterfly",
                                           corr_u_mid="global")),
    "weights-binary": (slice(None), dict(segments=4, merge_mode="butterfly",
                                         weights_binary=True)),
    "weights-binary-i8-block": (slice(8, 16), dict(segments=4, merge_mode="butterfly",
                                                   weights_binary=True, int8=True,
                                                   corr_u_mid="global")),
    "bounds-butterfly": (slice(None), dict(segments=4, merge_mode="butterfly",
                                           seg_bounds=(0, 2, 7, 12, 16))),
    "bounds-butterfly-empty": (slice(None), dict(segments=4, merge_mode="butterfly",
                                                 seg_bounds=(0, 5, 5, 11, 16))),
    "bounds-butterfly-empty-radix8": (slice(None), dict(
        segments=8, merge_mode="butterfly", seg_bounds=(0, 1, 3, 3, 3, 8, 10, 13, 16))),
    "bounds-flat-empty": (slice(None), dict(segments=4, seg_bounds=(0, 0, 6, 11, 16))),
    "bounds-clamped": (slice(0, 4), dict(segments=8, merge_mode="butterfly",
                                         seg_bounds=(0, 0, 1, 1, 2, 2, 3, 3, 4))),
}


@pytest.mark.parametrize("case", list(SHARD_CASES), ids=list(SHARD_CASES))
def test_splat_hist_sharded_arguments_match_jax(small_packets, case):
    """Within tests/test_torch_voting_hist.py's tolerance: relative L1 < 1e-2,
    vote mass within 0.5 %."""
    p, depths, vp, W, H = small_packets
    planes, kw = SHARD_CASES[case]
    kw = dict(kw)
    int8 = kw.pop("int8", False)
    d = depths[planes]
    if kw.get("corr_u_mid") == "global":
        u = 1.0 / depths.astype(np.float32)
        kw["corr_u_mid"] = np.float32(0.5) * (u.min() + u.max())
    want = np.asarray(jvh.splat_hist(
        p, jnp.asarray(d), float(depths[0]), vp, W, H, group_size=2, engine="pallas",
        bin_dtype=jnp.int8 if int8 else None,
        **{k: (jnp.float32(v) if k == "corr_u_mid" else v) for k, v in kw.items()}))
    got = to_np(tvh.splat_hist(
        convert.packets(p, "cpu"), torch.as_tensor(d), float(depths[0]), vp, W, H,
        group_size=2, engine="pallas", bin_dtype=torch.int8 if int8 else None,
        **{k: (torch.tensor(v) if k == "corr_u_mid" else v) for k, v in kw.items()}))
    assert got.shape == want.shape == (len(d), H, W)
    l1 = np.abs(got.astype(np.float64) - want).sum() / np.abs(want).sum()
    mass = got.astype(np.float64).sum() / want.sum() - 1
    assert l1 < 1e-2 and abs(mass) < 0.005, (l1, mass)


def test_splat_hist_refuses_bad_bounds(small_packets):
    p, depths, vp, W, H = small_packets
    with pytest.raises(ValueError, match="seg_bounds"):
        tvoting.resolve_backend("hist:g2,seg4,pl")(
            convert.packets(p, "cpu"), torch.as_tensor(depths), float(depths[0]), vp, W, H,
            seg_bounds=(0, 9, 5, 12, 16))


def test_weights_binary_refuses_fractional_weights(small_packets):
    """The port's binary mode checks the weights it is promised (the TPU
    kernel would count any w > 0 as 1)."""
    p, depths, vp, W, H = small_packets
    tp = convert.packets(p, "cpu")
    tp = tp._replace(weight=tp.weight * 0.5)
    with pytest.raises(ValueError, match="binary_w"):
        tvoting.resolve_backend("hist:g2,seg4,bf,pl")(
            tp, torch.as_tensor(depths), float(depths[0]), vp, W, H, weights_binary=True)


# ---------------------------------------------------------------------------
# The sharded step and the sharded voting step under `hist:g1,ss2`
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rig():
    return S.build_rig()


@pytest.fixture(scope="module")
def rank_outputs(rig, tmp_path_factory):
    return S.rank_outputs(rig, str(tmp_path_factory.mktemp("ranks")),
                          [("step", "g1ss2"), ("voting", "g1ss2")])


@pytest.mark.parametrize("kind", ["step", "voting"])
@pytest.mark.parametrize("shape", S.MESHES, ids=S.MESH_IDS)
def test_sharded_g1ss2_matches_jax_sharded(rig, rank_outputs, shape, kind):
    got = rank_outputs[(kind, "g1ss2", f"{shape[0]}x{shape[1]}")]
    S.check_vs_jax(got, S.jax_run(rig, kind, "g1ss2", shape), "g1ss2", kind)


@pytest.mark.parametrize("kind", ["step", "voting"])
@pytest.mark.parametrize("shape", S.MESHES, ids=S.MESH_IDS)
def test_sharded_g1ss2_matches_single_device(rig, rank_outputs, shape, kind):
    got = rank_outputs[(kind, "g1ss2", f"{shape[0]}x{shape[1]}")]
    S.check_vs_single(got, S.port_single(rig, "g1ss2", kind), "g1ss2", kind, shape)
