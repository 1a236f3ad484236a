"""The exact vote (`kernels.scatter`): `bilinear_corners` and the plain
version of `scatter_vote` at the edges of the image and on non-finite
coordinates, each against a float64 numpy vote; `splat_scatter` against the
previous plain form; the wrapper's dispatch and its refusals; the slabs of
the kernel's grid.

The test marked `card` needs an NVIDIA GPU and skips without one; this file
imports no JAX, so on the card it runs as

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_scatter.py
"""

import numpy as np
import pytest
import torch

from dvs_mcemvs_torch.kernels import scatter
from dvs_mcemvs_torch.ops import voting

W, H = 8, 6
INF, NAN = float("inf"), float("nan")
BELOW_W1 = float(np.nextafter(np.float32(W - 1), np.float32(0)))
BELOW_H1 = float(np.nextafter(np.float32(H - 1), np.float32(0)))

# (x, y) of one vote on a W x H image.
CORNER_CASES = {
    "x_inf": (INF, 2.5), "x_-inf": (-INF, 2.5), "x_nan": (NAN, 2.5),
    "y_inf": (2.5, INF), "y_-inf": (2.5, -INF), "y_nan": (2.5, NAN),
    "x_W-2": (W - 2.0, 2.5), "x_W-1": (W - 1.0, 2.5), "x_below_W-1": (BELOW_W1, 2.5),
    "y_H-2": (2.5, H - 2.0), "y_H-1": (2.5, H - 1.0), "y_below_H-1": (2.5, BELOW_H1),
    "-0.0": (-0.0, -0.0), "x_below_0": (-1e-7, 2.5), "inside": (3.25, 1.75),
}


def vote64(x, y, w, width, height):
    """Float64 numpy taps of votes (x, y, w): (flat indices, weights) of the
    in-bounds ones, where 0 <= x < width - 1 and 0 <= y < height - 1."""
    x, y, w = (np.asarray(v, np.float64).reshape(-1) for v in (x, y, w))
    with np.errstate(invalid="ignore"):
        inb = (x >= 0) & (x < width - 1) & (y >= 0) & (y < height - 1)
    x, y, w = x[inb], y[inb], w[inb]
    x0, y0 = np.floor(x), np.floor(y)
    fx, fy = x - x0, y - y0
    base = (y0 * width + x0).astype(np.int64)
    idx = np.stack([base, base + 1, base + width, base + width + 1], -1)
    wts = np.stack([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy], -1) * w[:, None]
    return idx, wts


@pytest.mark.parametrize("case", sorted(CORNER_CASES))
def test_bilinear_corners_at_the_edges(case):
    """Each vote's indices lie in the image and its weights are finite; an
    in-bounds vote's taps are the float64 ones, any other weighs 0."""
    x, y = CORNER_CASES[case]
    idx4, w4 = scatter.bilinear_corners(torch.tensor([x], dtype=torch.float32),
                                        torch.tensor([y], dtype=torch.float32), W, H)
    idx4, w4 = idx4.numpy()[0], w4.numpy()[0]
    assert ((idx4 >= 0) & (idx4 < W * H)).all(), idx4
    assert np.isfinite(w4).all(), w4
    want_idx, want_w = vote64(np.float32(x), np.float32(y), 1.0, W, H)
    if len(want_idx):
        np.testing.assert_array_equal(idx4, want_idx[0])
        np.testing.assert_allclose(w4, want_w[0], rtol=1e-6, atol=1e-7)
    else:
        assert not w4.any(), w4


def _packets(xy, weight=None, valid=None):
    """Packets whose Eq. 15 transfer is the identity on planes at depths of
    powers of two (camera centers 0, z0 = 1: a = d = depth, bx = by = 0), so
    the votes land at `xy` exactly."""
    xy = np.asarray(xy, np.float32)
    K, P, _ = xy.shape
    f32 = dict(dtype=torch.float32)
    return voting.WarpedPackets(
        torch.as_tensor(xy), torch.zeros((K, 3), **f32),
        torch.ones(K, dtype=torch.bool) if valid is None else torch.as_tensor(valid),
        None if weight is None else torch.as_tensor(weight, **f32))


DEPTHS = torch.tensor([1.0, 2.0, 0.5, 4.0])
VCAM = (5.0, 5.0, W / 2, H / 2)


def _splat_cases():
    rng = np.random.default_rng(7)
    inside = np.stack([rng.uniform(0, W - 1, (2, 16)), rng.uniform(0, H - 1, (2, 16))], -1)
    odd = np.array([[INF, 1.5], [-INF, 1.5], [NAN, 1.5], [1.5, INF], [1.5, -INF],
                    [1.5, NAN], [INF, INF], [NAN, NAN]], np.float32)
    edges = np.array([[W - 2, 2.5], [W - 1, 2.5], [BELOW_W1, 2.5], [2.5, H - 2],
                      [2.5, H - 1], [2.5, BELOW_H1], [BELOW_W1, BELOW_H1], [W - 2, H - 2]],
                     np.float32)
    zeros = np.array([[-0.0, -0.0], [-0.0, 2.5], [2.5, -0.0], [0.0, 0.0],
                      [-1e-7, 2.5], [2.5, -1e-7], [-0.0, BELOW_H1], [BELOW_W1, -0.0]],
                     np.float32)
    weighted = rng.uniform(0, 2, (2, 16)) * (rng.uniform(size=(2, 16)) > 0.3)
    return {
        "non_finite": (np.stack([odd, inside[0, :8]]), None, None),
        "edges": (np.stack([edges, inside[0, :8]]), None, None),
        "negative_zero": (np.stack([zeros, inside[1, :8]]), None, None),
        "zero_weight": (inside, weighted, None),
        "invalid_packets": (inside, weighted, np.array([True, False])),
    }


SPLAT_CASES = _splat_cases()


@pytest.mark.parametrize("case", sorted(SPLAT_CASES))
def test_splat_scatter_plain_version_at_the_edges(case):
    """`splat_scatter` on the CPU (the plain version) against a float64
    numpy vote of the same events into every plane: finite, equal within
    float32 rounding, and non-zero on the same voxels."""
    xy, weight, valid = SPLAT_CASES[case]
    xy = np.asarray(xy, np.float32)
    packets = _packets(xy, weight, valid)
    got = voting.splat_scatter(packets, DEPTHS, 1.0, VCAM, W, H, plane_block=3).numpy()
    assert got.shape == (len(DEPTHS), H, W)
    assert np.isfinite(got).all()
    w = packets.event_weights().numpy()
    idx, wts = vote64(xy[..., 0], xy[..., 1], w, W, H)
    plane = np.zeros(W * H)
    np.add.at(plane, idx.reshape(-1), wts.reshape(-1))
    want = np.broadcast_to(plane.reshape(H, W), got.shape)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got != 0, want != 0)


def _previous_splat_scatter(packets, depths, z0, vcam_params, width, height, plane_block=8):
    """The previous plain form (corners decided after the int64 floor), the
    oracle on finite coordinates."""
    fx, fy, cx, cy = vcam_params
    K, P, _ = packets.xy_z0.shape
    xy = packets.xy_z0.reshape(K * P, 2)
    pw = packets.event_weights()
    out = torch.zeros((depths.shape[0], height * width))
    for z_lo in range(0, depths.shape[0], plane_block):
        sl = slice(z_lo, min(z_lo + plane_block, depths.shape[0]))
        a, bx, by, d = (c.T.repeat_interleave(P, dim=1) for c in voting.eq15_coefficients(
            packets.centers, depths[sl], z0, fx, fy, cx, cy))
        X = (xy[None, :, 0] * a + bx) / d
        Y = (xy[None, :, 1] * a + by) / d
        x0, y0 = torch.floor(X).to(torch.int64), torch.floor(Y).to(torch.int64)
        inb = (X >= 0) & (Y >= 0) & (x0 + 1 < width) & (y0 + 1 < height)
        fx_, fy_ = X - x0.to(X.dtype), Y - y0.to(Y.dtype)
        base = torch.where(inb, y0, 0) * width + torch.where(inb, x0, 0)
        idx4 = torch.stack([base, base + 1, base + width, base + width + 1], dim=-1)
        w4 = torch.stack([(1 - fx_) * (1 - fy_), fx_ * (1 - fy_), (1 - fx_) * fy_,
                          fx_ * fy_], dim=-1)
        w4 = torch.where(inb[..., None], w4, torch.zeros_like(w4)) * pw[None, :, None]
        for zb, z in enumerate(range(sl.start, sl.stop)):
            out[z].index_add_(0, idx4[zb].reshape(-1), w4[zb].reshape(-1))
    return out.reshape(-1, height, width)


@pytest.mark.parametrize("plane_block", [1, 3, 8])
def test_splat_scatter_is_the_previous_one_on_finite_votes(plane_block):
    """On finite coordinates, in and out of the image, through real Eq. 15
    coefficients, the plain version equals the previous form to the bit."""
    rng = np.random.default_rng(11)
    K, P, w, h = 6, 128, 40, 30
    xy = np.stack([rng.uniform(-8, w + 8, (K, P)), rng.uniform(-8, h + 8, (K, P))], -1)
    f32 = dict(dtype=torch.float32)
    packets = voting.WarpedPackets(
        torch.as_tensor(xy, **f32), torch.as_tensor(rng.normal(0, 0.05, (K, 3)), **f32),
        torch.as_tensor(rng.uniform(size=K) > 0.2),
        torch.as_tensor(rng.uniform(0, 2, (K, P)) * (rng.uniform(size=(K, P)) > 0.2), **f32))
    depths = torch.linspace(1.0, 4.0, 10)
    vcam = (30.0, 30.0, w / 2, h / 2)
    got = voting.splat_scatter(packets, depths, 1.0, vcam, w, h, plane_block=plane_block)
    want = _previous_splat_scatter(packets, depths, 1.0, vcam, w, h)
    assert float(want.sum()) > 0
    assert torch.equal(got, want)


def _wrapper_args(E=64, K=4, Z=3):
    rng = np.random.default_rng(3)
    f32 = dict(dtype=torch.float32)
    xy = torch.as_tensor(np.stack([rng.uniform(0, W, E), rng.uniform(0, H, E)], -1), **f32)
    pw = torch.as_tensor(rng.uniform(0, 1, E), **f32)
    coef = torch.as_tensor(rng.uniform(0.9, 1.1, (K, Z, 4)), **f32)
    return xy, pw, coef


WRAPPER_CASES = {
    "cpu_runs_the_plain_version": (lambda xy, pw, c: (xy, pw, c), None),
    "float64_xy": (lambda xy, pw, c: (xy.double(), pw, c), TypeError),
    "float64_coef": (lambda xy, pw, c: (xy, pw, c.double()), TypeError),
    "xy_not_e_by_2": (lambda xy, pw, c: (xy.reshape(-1, 4), pw, c), ValueError),
    "pw_length": (lambda xy, pw, c: (xy, pw[1:], c), ValueError),
    "coef_not_k_z_4": (lambda xy, pw, c: (xy, pw, c[..., :3].contiguous()), ValueError),
    "uneven_packets": (lambda xy, pw, c: (xy, pw, c.repeat(2, 1, 1)[:7]), ValueError),
    "non_contiguous_xy": (lambda xy, pw, c: (xy.T.contiguous().T, pw, c), ValueError),
    "non_contiguous_coef": (lambda xy, pw, c: (xy, pw, c.transpose(0, 1).contiguous()
                                               .transpose(0, 1)), ValueError),
    "two_devices": (lambda xy, pw, c: (xy, pw.to("meta"), c), ValueError),
}


@pytest.mark.parametrize("case", sorted(WRAPPER_CASES))
def test_scatter_vote_wrapper(case):
    """A CPU tensor runs the plain version and counts no launch; a wrong
    dtype, shape, packet split, layout or device raises."""
    make, error = WRAPPER_CASES[case]
    args = make(*_wrapper_args())
    before = scatter.scatter_vote.launches
    if error is not None:
        with pytest.raises(error):
            scatter.scatter_vote(*args, width=W, height=H)
        return
    got = scatter.scatter_vote(*args, width=W, height=H, plane_block=2)
    assert torch.equal(got, scatter.scatter_vote_reference(*args, W, H))
    assert float(got.sum()) > 0
    assert scatter.scatter_vote.launches == before


@pytest.mark.parametrize("Z,height,width,planes", [
    (100, 480, 640, 10),    # DSEC: 1.2 MB planes, 10 slabs
    (50, 480, 640, 10),     # a plane-sharded half of DSEC's depths
    (100, 260, 346, 34),    # MVSEC: 0.36 MB planes, 3 slabs
    (7, 2000, 2000, 1),     # a plane larger than a slab
    (1, 4, 4, 1),
])
def test_slab_planes(Z, height, width, planes):
    """As many planes a slab as fit SLAB_BYTES, evened out over the slabs
    that Z needs."""
    got = scatter.slab_planes(Z, height, width)
    assert got == planes
    assert got == 1 or got * 4 * height * width <= scatter.SLAB_BYTES
    per = max(1, scatter.SLAB_BYTES // (4 * height * width))
    assert -(-Z // got) == -(-Z // per)


@pytest.mark.card
def test_kernel_matches_plain_version_on_the_card():
    """On the card, the kernel against its plain version on the card: the
    edge and non-finite cases above and a weighted chunk of real Eq. 15
    coefficients with invalid packets; the same non-zero voxels, relative
    L1 at most 1e-6 (the order of the sums only), one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    for case, (xy, weight, valid) in SPLAT_CASES.items():
        packets = _packets(xy, weight, valid)
        K, P, _ = packets.xy_z0.shape
        coef = torch.stack(voting.eq15_coefficients(packets.centers, DEPTHS, 1.0, *VCAM), -1)
        args = (packets.xy_z0.reshape(K * P, 2), packets.event_weights(), coef)
        want = scatter.scatter_vote_reference(*args, W, H)
        before = scatter.scatter_vote.launches
        got = scatter.scatter_vote(*(a.to(dev) for a in args), width=W, height=H).cpu()
        assert scatter.scatter_vote.launches == before + 1, case
        np.testing.assert_array_equal(got != 0, want != 0, err_msg=case)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=case)
    rng = np.random.default_rng(13)
    K, P, w, h = 64, 1024, 346, 260
    f32 = dict(dtype=torch.float32, device=dev)
    xy = np.stack([rng.uniform(-20, w + 20, (K, P)), rng.uniform(-20, h + 20, (K, P))], -1)
    packets = voting.WarpedPackets(
        torch.as_tensor(xy, **f32), torch.as_tensor(rng.normal(0, 0.05, (K, 3)), **f32),
        torch.as_tensor(rng.uniform(size=K) > 0.1, device=dev),
        torch.as_tensor(rng.uniform(0, 1, (K, P)) * (rng.uniform(size=(K, P)) > 0.1), **f32))
    depths = torch.linspace(1.0, 6.5, 100, device=dev)
    vcam = (226.0, 226.0, w / 2, h / 2)
    coef = torch.stack(voting.eq15_coefficients(packets.centers, depths, 1.0, *vcam), -1)
    args = (packets.xy_z0.reshape(K * P, 2), packets.event_weights(), coef)
    want = scatter.scatter_vote_reference(*args, w, h)
    got = voting.splat_scatter(packets, depths, 1.0, vcam, w, h)
    assert torch.equal(got != 0, want != 0)
    l1 = float((got - want).abs().sum() / want.abs().sum())
    assert l1 <= 1e-6, l1
