"""The exact vote (`kernels.scatter`): `bilinear_corners` and the plain
version of `scatter_vote` at the edges of the image and on non-finite
coordinates, each against a float64 numpy vote; `splat_scatter` against the
previous plain form; the wrapper's dispatch and its refusals; the gather's
sizes, its plan (conservative on every geometry), its bin pass and its
algorithm in plain PyTorch against the plain vote.

The tests marked `card` need an NVIDIA GPU and skip without one; this file
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


# (Z, height, width, K, P) -> (tile_w, tile_h, slab, group, cell, border,
# pitch) on an H100.
VOTE_PARAMS_CASES = {
    "dsec": ((100, 480, 640, 1024, 1024), (128, 128, 3, 128, 16, 80, 133)),
    "dsec_plane_sharded_half": ((50, 480, 640, 1024, 1024), (128, 128, 3, 128, 16, 80, 133)),
    "mvsec": ((100, 260, 346, 128, 1024), (128, 128, 3, 128, 16, 48, 133)),
    "tumvie_hd": ((100, 720, 1280, 4096, 1024), (128, 128, 3, 128, 16, 160, 133)),
    "plane_past_shared_memory": ((7, 3000, 4000, 10, 1024), (128, 128, 3, 10, 32, 512, 133)),
    "one_4x4_plane": ((1, 4, 4, 1, 16), (4, 4, 1, 1, 16, 16, 5)),
}


@pytest.mark.parametrize("case", sorted(VOTE_PARAMS_CASES))
def test_vote_params(case):
    """The gather's sizes follow the shapes: TILE_W x TILE_H tiles (the
    image's side where smaller), as many planes a slab as a block's shared
    memory holds, evened out over the slabs, GROUP_EVENTS events a group, and
    cells that keep the grid, BORDER_SHARE of
    the larger side past the image, within MAX_CELLS cells and SEGMENTS
    rows."""
    (Z, height, width, K, P), want = VOTE_PARAMS_CASES[case]
    p = scatter.vote_params(Z, height, width, K, P)
    assert tuple(p) == want
    budget = scatter.SMEM_PER_BLOCK - scatter.VOTE_STATIC_SMEM
    assert 4 * p.pitch * p.tile_h * p.slab <= budget
    assert p.pitch >= p.tile_w and p.pitch % 32 == 5 % 32
    per = min(scatter.MAX_SLAB, budget // (4 * p.pitch * p.tile_h))
    assert -(-Z // p.slab) == -(-Z // per)
    g = scatter.grid_shape(p, K, Z, height, width)
    assert g["cells_x"] * g["cells_y"] <= scatter.MAX_CELLS
    assert g["cells_y"] <= scatter.SEGMENTS
    assert p.cell & (p.cell - 1) == 0
    assert p.border % p.cell == 0 and p.border >= max(width, height) * scatter.BORDER_SHARE
    assert p.group * P <= max(scatter.GROUP_EVENTS, P) and p.group <= K


def test_vote_params_shrink_the_tile_to_the_shared_memory():
    """On a card with less shared memory the tile loses rows, never below
    one plane a slab."""
    p = scatter.vote_params(100, 720, 1280, 4096, 1024, smem=32 << 10)
    budget = (32 << 10) - scatter.VOTE_STATIC_SMEM
    assert p.tile_w == scatter.TILE_W and p.slab == 1
    assert p.tile_h == budget // (4 * p.pitch) < scatter.TILE_H


def _bin_case(name):
    """(xy, pw, P, params, width, height) of a bin-pass case."""
    rng = np.random.default_rng(len(name))
    K, P, w, h = 12, 32, 70, 50
    E = K * P
    xy = np.stack([rng.uniform(-20, w + 20, E), rng.uniform(-20, h + 20, E)], -1)
    pw = rng.uniform(0.1, 2, E)
    if name == "pad_and_invalid":
        pw[-100:] = 0                       # a bucket pad
        pw[2 * P:3 * P] = 0                 # an invalid packet
    elif name == "non_finite":
        xy[::9, 0] = np.inf
        xy[1::9, 1] = np.nan
        xy[2::9, 0] = -np.inf
    elif name == "far_off_the_image":
        xy[::5] = rng.choice([-1e6, 1e6, -3.5, w + 7.25], (len(xy[::5]), 2))
    elif name == "one_cell":
        xy[:] = [3.5, 2.5]
    params = scatter.VoteParams(16, 16, 2, 5, 8, 8, scatter.row_pitch(16))
    f32 = dict(dtype=torch.float32)
    return torch.as_tensor(xy, **f32), torch.as_tensor(pw, **f32), P, params, w, h


@pytest.mark.parametrize("case", ["pad_and_invalid", "non_finite", "far_off_the_image",
                                  "one_cell", "plain"])
def test_bin_pass_plain_version(case):
    """Every event with a weight and a finite z0 location lands once, in its
    (group, cell), the cell of its location clamped to the grid; the pad,
    invalid packets and non-finite locations drop out; events keep their
    order within a cell; each group's rows start at its first event."""
    xy, pw, P, params, w, h = _bin_case(case)
    binned, off = scatter.bin_events_reference(xy, pw, P, params, w, h)
    E = xy.shape[0]
    g = scatter.grid_shape(params, E // P, 1, h, w)
    cw, ch = g["cells_x"], g["cells_y"]
    ge = params.group * P
    assert off.dtype == torch.int32 and off.shape == (g["groups"], cw * ch + 1)
    xy_, pw_ = xy.numpy(), pw.numpy()
    keep = (pw_ != 0) & np.isfinite(xy_).all(1)
    cells = (np.clip(np.floor((np.nan_to_num(xy_[:, 1]) + params.border) / params.cell), 0,
                     ch - 1) * cw
             + np.clip(np.floor((np.nan_to_num(xy_[:, 0]) + params.border) / params.cell), 0,
                       cw - 1))
    rows = binned.numpy()
    k = binned[:, 3].contiguous().view(torch.int32).numpy()
    seen = []
    for gi in range(g["groups"]):
        o = off[gi].numpy()
        assert o[0] == gi * ge and (np.diff(o) >= 0).all()
        assert (rows[o[-1]:min((gi + 1) * ge, E)] == 0).all()
        for c in range(cw * ch):
            want = [e for e in range(gi * ge, min((gi + 1) * ge, E)) if keep[e] and cells[e] == c]
            got = rows[o[c]:o[c + 1]]
            assert len(got) == len(want), (gi, c)
            np.testing.assert_array_equal(got[:, :3], np.stack([xy_[want, 0], xy_[want, 1],
                                                                pw_[want]], -1).reshape(-1, 3))
            np.testing.assert_array_equal(k[o[c]:o[c + 1]], np.array(want, int) // P)
            seen += want
    assert sorted(seen) == list(np.flatnonzero(keep))


def _plan_coef(name, K, Z, width, height, rng):
    """(K, Z, 4) float32 Eq. 15 tables of plan cases."""
    f32 = dict(dtype=torch.float32)
    if name in ("forward_ride", "tile_edges_ride"):
        # z0 the far plane, planes in inverse depth over 3-100 m, a +-1 m
        # forward ride with a little sway (camera centers of the RV frame).
        centers = torch.as_tensor(np.stack([rng.normal(0, 0.1, K) + 0.12, rng.normal(0, 0.03, K),
                                            np.linspace(-1, 1, K)], -1), **f32)
        depths = 1.0 / torch.linspace(1 / 100, 1 / 3, Z)
        return torch.stack(voting.eq15_coefficients(
            centers, depths, float(depths[0]), width * 0.47, width * 0.47, width / 2 - 1.6,
            height / 2 + 13.1), -1).contiguous()
    if name == "identity":
        coef = torch.zeros((K, Z, 4))
        coef[..., 0] = coef[..., 3] = 1.0
        return coef
    a = rng.choice([-1, 1], (K, Z)) * rng.uniform(0.3, 2.5, (K, Z))
    d = rng.choice([-1, 1], (K, Z)) * rng.uniform(0.3, 2.5, (K, Z))
    bx, by = rng.normal(0, 60, (K, Z)), rng.normal(0, 40, (K, Z))
    if name == "off_the_image":
        a[:, ::2] = rng.uniform(1e-4, 1e-3, (K, (Z + 1) // 2))   # far z0 locations land inside
        bx[:, ::2], by[:, ::2] = width / 2, height / 2
    coef = torch.as_tensor(np.stack([a, bx, by, d], -1), **f32)
    if name == "zero_a":
        coef[3, 1, 0] = 0.0
        coef[7, 4, 0] = 0.0
    elif name == "non_finite":
        coef[2, 0, 1] = float("inf")
        coef[9, 3, 3] = float("nan")
        coef[5, 5, 2] = -float("inf")
    return coef


def _plan_events(name, K, P, width, height, params, rng):
    E = K * P
    xy = np.stack([rng.uniform(-30, width + 30, E), rng.uniform(-30, height + 30, E)], -1)
    if name == "off_the_image":
        xy[::3] = rng.choice([-1e5, 1e5, -4e3, 4e3], (len(xy[::3]), 2))
    if name in ("tile_edges_ride", "identity"):
        # On tile edges, a hair either side, and on the corners.
        ex = np.arange(0, width + 1, params.tile_w, dtype=np.float32)
        ey = np.arange(0, height + 1, params.tile_h, dtype=np.float32)
        near = lambda v: np.concatenate([v - 1, v - 0.5, v, np.nextafter(v, -np.inf),
                                         np.nextafter(v, np.inf)])
        gx, gy = np.meshgrid(near(ex), near(ey))
        n = min(E // 2, gx.size)
        xy[:n] = np.stack([gx.ravel()[:n], gy.ravel()[:n]], -1)
    return torch.as_tensor(xy, dtype=torch.float32)


PLAN_CASES = ["forward_ride", "tile_edges_ride", "identity", "random_signs", "off_the_image",
              "zero_a", "non_finite"]


def _taps_by_block(xy, coef, params, width, height):
    """For each event, plane and tap of the plain vote's float32 transfer
    that lands in the image: (event, slab, tile column, tile row)."""
    K, Z, _ = coef.shape
    P = xy.shape[0] // K
    a, bx, by, d = (coef[..., i].T.repeat_interleave(P, dim=1) for i in range(4))
    X = (xy[None, :, 0] * a + bx) / d
    Y = (xy[None, :, 1] * a + by) / d
    inb = (X >= 0) & (X < width - 1) & (Y >= 0) & (Y < height - 1)
    z, e = torch.nonzero(inb, as_tuple=True)
    x0, y0 = torch.floor(X[z, e]).long(), torch.floor(Y[z, e]).long()
    out = []
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        out.append(torch.stack([e, z // params.slab, (x0 + dx) // params.tile_w,
                                (y0 + dy) // params.tile_h], 1))
    return torch.unique(torch.cat(out), dim=0)


@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_is_conservative(case):
    """Every event with a tap in a tile lies in a cell that the plan has the
    tile visit, in every slab: on a ridden forward path with z0 the far
    plane, tables with a/d < 0 and random offsets, z0 locations far off the
    image that other planes map in, events on tile edges and corners, and
    a = 0 or non-finite coefficients, whose (slab, group) falls back to
    every cell."""
    rng = np.random.default_rng(PLAN_CASES.index(case))
    K, P, Z, width, height = 24, 48, 10, 150, 90
    params = scatter.VoteParams(32, 16, 3, 5, 8, 16, scatter.row_pitch(32))
    coef = _plan_coef(case, K, Z, width, height, rng)
    xy = _plan_events(case, K, P, width, height, params, rng)
    xr, yr, fb = scatter.vote_plan(coef, params, width, height)
    g = scatter.grid_shape(params, K, Z, height, width)
    assert xr.shape == (g["slabs"], g["groups"], g["tiles_x"], 2) and xr.dtype == torch.int32
    assert yr.shape == (g["slabs"], g["groups"], g["tiles_y"], 2)
    assert fb.shape == (g["slabs"], g["groups"])
    assert (xr[..., 0] <= xr[..., 1]).all() and (yr[..., 0] <= yr[..., 1]).all()
    assert xr.min() >= 0 and xr.max() < g["cells_x"]
    assert yr.min() >= 0 and yr.max() < g["cells_y"]
    taps = _taps_by_block(xy, coef, params, width, height)
    assert len(taps) > 100
    e, s, tj, ti = taps.unbind(1)
    grp = e // P // params.group
    cx = torch.floor((xy[e, 0] + params.border) / params.cell).clamp(0, g["cells_x"] - 1).long()
    cy = torch.floor((xy[e, 1] + params.border) / params.cell).clamp(0, g["cells_y"] - 1).long()
    rx, ry = xr[s, grp, tj], yr[s, grp, ti]
    inside = (rx[:, 0] <= cx) & (cx <= rx[:, 1]) & (ry[:, 0] <= cy) & (cy <= ry[:, 1])
    assert inside.all(), taps[~inside][:5]
    bad_planes = {"zero_a": [(3, 1), (7, 4)], "non_finite": [(2, 0), (9, 3), (5, 5)]}.get(case, [])
    want_fb = torch.zeros_like(fb)
    for k, z in bad_planes:
        want_fb[z // params.slab, k // params.group] = 1
    assert torch.equal(fb, want_fb)
    full = fb.bool()
    assert (xr[full][..., 0] == 0).all() and (xr[full][..., 1] == g["cells_x"] - 1).all()
    assert (yr[full][..., 0] == 0).all() and (yr[full][..., 1] == g["cells_y"] - 1).all()
    if case == "forward_ride":
        # The plan gathers: most (slab, group, tile) visit a few cells, not all.
        cells = ((xr[..., 1] - xr[..., 0] + 1)[:, :, :, None]
                 * (yr[..., 1] - yr[..., 0] + 1)[:, :, None, :]).double()
        assert float(cells.mean()) < 0.5 * g["cells_x"] * g["cells_y"]


def _gather(xy, pw, coef, params, width, height):
    """The vote pass of csrc/scatter.cu in plain PyTorch over the plain bin
    pass and the plan: each (slab, tile) block walks its plan's (group,
    cell row) segments of binned events and adds only the taps that land in
    its tile.  Returns the DSI and the visits and hits it counted."""
    K, Z, _ = coef.shape
    P = xy.shape[0] // K
    g = scatter.grid_shape(params, K, Z, height, width)
    binned, off = scatter.bin_events_reference(xy, pw, P, params, width, height)
    xr, yr, _ = scatter.vote_plan(coef, params, width, height)
    cw = g["cells_x"]
    out = torch.zeros((Z, height * width))
    visits = hits = 0
    for s in range(g["slabs"]):
        planes = range(s * params.slab, min((s + 1) * params.slab, Z))
        for ti in range(g["tiles_y"]):
            for tj in range(g["tiles_x"]):
                x0, y0 = tj * params.tile_w, ti * params.tile_h
                x1, y1 = min(x0 + params.tile_w, width), min(y0 + params.tile_h, height)
                idx = [torch.arange(int(off[gi, cy * cw + xr[s, gi, tj, 0]]),
                                    int(off[gi, cy * cw + xr[s, gi, tj, 1] + 1]))
                       for gi in range(g["groups"])
                       for cy in range(int(yr[s, gi, ti, 0]), int(yr[s, gi, ti, 1]) + 1)]
                ev = binned[torch.cat(idx)]
                k = ev[:, 3].contiguous().view(torch.int32).long()
                visits += len(ev) * len(planes)
                for z in planes:
                    a, bx, by, d = coef[k, z].unbind(-1)
                    idx4, w4 = scatter.bilinear_corners((ev[:, 0] * a + bx) / d,
                                                        (ev[:, 1] * a + by) / d, width, height)
                    vy, vx = idx4 // width, idx4 % width
                    mine = (vx >= x0) & (vx < x1) & (vy >= y0) & (vy < y1) & (w4 != 0)
                    hits += int(mine.any(1).sum())
                    out[z].index_add_(0, idx4[mine], (w4 * ev[:, 2:3])[mine])
    return out.reshape(Z, height, width), visits, hits


@pytest.mark.parametrize("case", ["forward_ride", "tile_edges_ride", "random_signs",
                                  "off_the_image"])
def test_gather_over_the_plan_is_the_plain_vote(case):
    """The gather's algorithm (bins, plan, segments, taps kept in the
    block's tile) gives the plain vote: the same non-zero voxels, equal
    within the order of the sums; it visits at least the event-planes it
    hits."""
    rng = np.random.default_rng(40 + PLAN_CASES.index(case))
    K, P, Z, width, height = 12, 40, 7, 100, 60
    params = scatter.VoteParams(32, 16, 3, 5, 8, 16, scatter.row_pitch(32))
    coef = _plan_coef(case, K, Z, width, height, rng)
    xy = _plan_events(case, K, P, width, height, params, rng)
    pw = torch.as_tensor(rng.uniform(0, 2, K * P) * (rng.uniform(size=K * P) > 0.2),
                         dtype=torch.float32)
    got, visits, hits = _gather(xy, pw, coef, params, width, height)
    want = scatter.scatter_vote_reference(xy, pw, coef, width, height)
    assert float(want.abs().sum()) > 0
    assert visits >= hits > 0
    assert torch.equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.card
def test_kernel_matches_plain_version_on_the_card():
    """On the card, the kernel against its plain version on the card: the
    edge and non-finite cases above, a weighted chunk of real Eq. 15
    coefficients with invalid packets, and a TUM-VIE-shaped camera with its
    pad and events on the tiles' corners; the same non-zero voxels, relative
    L1 at most 1e-6 (the order of the sums only), one launch a call, and on
    the TUM-VIE shape visits >= hits > 0 and no fallback."""
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
    del got, want
    # TUM-VIE's shape: 1280 x 720 x 100, z0 the far plane, a +-1 m forward
    # ride, 28.5 % zero-weight pad, and events on the tiles' corners.
    K, P, w, h, Z = 1024, 1024, 1280, 720, 100
    xy, pw, coef = _ride(K, P, w, h, Z, rng, dev)
    counts = scatter.vote_counters()
    got = scatter.scatter_vote(xy, pw, coef, width=w, height=h)
    torch.cuda.synchronize()
    gained = {k: v - counts[k] for k, v in scatter.vote_counters().items()}
    want = scatter.scatter_vote_reference(xy, pw, coef, w, h)
    assert torch.equal(got != 0, want != 0)
    l1 = float((got.double() - want.double()).abs().sum() / want.double().abs().sum())
    assert l1 <= 1e-6, l1
    assert gained["visits"] >= gained["hits"] > 0 and gained["fallbacks"] == 0, gained


def _ride(K, P, width, height, Z, rng, dev):
    """(xy, pw, coef) of a TUM-VIE-shaped camera on the card: uniform z0
    locations 40 px past the image, a quarter of the first packets' on the
    64 px tiles' corners and a hair either side, planes in inverse depth
    over 3-100 m with z0 the far one, camera centers on a +-1 m forward ride
    with sway, and the last 28.5 % of the events zero-weight pad."""
    E = K * P
    xy = np.stack([rng.uniform(-40, width + 40, E), rng.uniform(-40, height + 40, E)], -1)
    cx = np.arange(0, width + 1, 64, dtype=np.float32)
    cy = np.arange(0, height + 1, 64, dtype=np.float32)
    near = lambda v: np.concatenate([v, np.nextafter(v, -np.inf), np.nextafter(v, np.inf),
                                     v - 1, v + 0.5])
    gx, gy = np.meshgrid(near(cx), near(cy))
    corners = np.stack([gx.ravel(), gy.ravel()], -1)
    n = E // 4 // len(corners) * len(corners)
    xy[:n] = np.tile(corners, (n // len(corners), 1))
    pw = rng.uniform(0.2, 1.0, E)
    pw[int(E * (1 - 0.285)):] = 0.0
    f32 = dict(dtype=torch.float32, device=dev)
    centers = torch.as_tensor(np.stack([0.12 + rng.normal(0, 0.05, K), rng.normal(0, 0.02, K),
                                        np.linspace(-1, 1, K)], -1), **f32)
    depths = 1.0 / torch.linspace(1 / 100, 1 / 3, Z, device=dev)
    coef = torch.stack(voting.eq15_coefficients(centers, depths, float(depths[0]), 598.32,
                                                598.32, 638.4, 373.1), -1).contiguous()
    return torch.as_tensor(xy, **f32), torch.as_tensor(pw, **f32), coef


@pytest.mark.card
def test_bin_pass_matches_plain_version_on_the_card():
    """The card's bin pass against its plain version: the same offsets, and
    in each cell the same events (in any order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    K, P, w, h = 96, 1024, 1280, 720
    xy, pw, coef = _ride(K, P, w, h, 4, rng, dev)
    xy[::11, 0] = float("nan")
    xy[1::13] = 1e6
    params = scatter.vote_params(4, h, w, K, P)
    binned, off = scatter.bin_events(xy, pw, P, params, w, h)
    want_binned, want_off = scatter.bin_events_reference(xy.cpu(), pw.cpu(), P, params, w, h)
    assert torch.equal(off.cpu(), want_off)
    for o in want_off.numpy():
        cell = np.repeat(np.arange(len(o) - 1), np.diff(o))

        def in_order(rows):
            r = rows.cpu().numpy()[o[0]:o[-1]]
            return r[np.lexsort((r[:, 2], r[:, 1], r[:, 0], r[:, 3].view(np.int32), cell))]

        np.testing.assert_array_equal(in_order(binned), in_order(want_binned))


@pytest.mark.card
@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_matches_plain_version_on_the_card(case):
    """The card's plan (csrc/scatter.cu: plan_bounds, plan_cells) equals
    `vote_plan`, its plain version, on the plan cases' tables and at
    TUM-VIE's shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    rng = np.random.default_rng(PLAN_CASES.index(case))
    K, Z, width, height = 24, 10, 150, 90
    params = scatter.VoteParams(32, 16, 3, 5, 8, 16, scatter.row_pitch(32))
    shapes = [(_plan_coef(case, K, Z, width, height, rng), params, width, height)]
    if case == "forward_ride":
        _, _, coef = _ride(256, 16, 1280, 720, 100, rng, dev)
        shapes.append((coef.cpu(), scatter.vote_params(100, 720, 1280, 256, 1024), 1280, 720))
    for coef, p, w, h in shapes:
        want = scatter.vote_plan(coef, p, w, h)
        got = scatter.plan(coef.to(dev), p, w, h)
        for g_, w_ in zip(got, want):
            assert torch.equal(g_.cpu(), w_)
