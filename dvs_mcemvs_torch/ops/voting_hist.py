"""Histogram + separable affine-resample voting on the hand-written kernels.

Port of dvs_mcemvs_tpu/ops/voting_hist.py, every `hist:` spec on both of
its engines:

1. Packets are grouped into super-packets sharing one camera center
   (`group_size`); a first-order per-event shift (`_sweep_correction`) keeps
   the grouping from tilting the vote rays (off with `correct=False`).
2. Each group's z0 locations are binned bilinearly into a z0 histogram on a
   grid padded by `pad_x`/`pad_y` and refined `supersample` times
   (`kernels.binning.bin_events`; bf16 taps, or int8 ones with
   `bin_dtype=torch.int8`).
3. With `segments` > 1 the inverse-depth sweep is split into segments and
   the leaf histograms are merged into supergroups per segment: by a
   butterfly of frame-change resamples (`merge_mode="butterfly"`,
   `_merge_butterfly`) or by one flat merge per segment
   (`merge_leaf_histograms`), both on `kernels.resample`.
4. Every depth plane is the sum of its (super)groups' histograms resampled
   under the Eq. (15) affine map: one fan-in call over all segments after
   the butterfly (`_sweep_planes_fanin`), else one (N, K) sum call per
   segment or for the whole sweep (`_sweep_planes`).

Histograms and merge levels are bf16 with f32 accumulation, or f32 with
`dtype=torch.float32`.  Border semantics diverge from the C++ reference as
in the JAX package: partial bilinear taps at the image edge are kept.

The JAX package has two engines for the same binning, merge and sweep
math (its voting_hist.py:611-613): its Pallas kernels (`engine="pallas"`,
spec token "pl") and one-hot matmuls (`engine="xla"`, specs without "pl").
The port runs both on kernels A and B, never building the one-hot tap
matrices.  What the engine changes here is what it changes there: the
Pallas engine rounds the histogram grid up to 64 rows and 128 columns,
the one-hot engine keeps (H + 2 pad_y) ss x (W + 2 pad_x) ss, and only the
Pallas engine has the butterfly merge.  The one-hot engine rounds its
binning and resample taps, its y-stage sums and its histograms to bf16 at
the kernels' points, but bins with f32 taps under `f32`, where kernel A
keeps bf16 taps: a relative change below 2^-9 a tap.  The JAX package
degrades a Pallas spec whose grid exceeds the TPU's scoped VMEM to its
one-hot engine; the card has no such limit, so the port never does.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.binning import bin_events
from ..kernels.resample import (banded_resample_fanin, banded_resample_sum, cached_index,
                                cached_items, fanin_tables, sum_tables)
from .voting import WarpedPackets

# Default z0-grid padding in bins (spec tokens px<N>/py<N>): events whose z0
# location is out of frame still vote on the planes where they land in frame.
# Default supersampling (ss<k>): none.
PAD_X, PAD_Y, SUPERSAMPLE = 128, 32, 1

# Butterfly-merge levels at or above this radix run on the fan-in wrapper,
# below it on the (N, K) sum wrapper -- the same split as the JAX package, so
# both packages run the same sums in the same grouping.
_FANIN_MIN_RADIX = 8


def _group_centers(packets: WarpedPackets, group_size: int) -> torch.Tensor:
    """Mean camera center over each super-packet's valid packets."""
    K = packets.centers.shape[0]
    G = -(-K // group_size)
    pad_k = G * group_size - K
    vb = packets.valid.to(torch.float32)
    cent = F.pad(packets.centers, (0, 0, 0, pad_k))
    vbp = F.pad(vb, (0, pad_k))
    cg = cent.reshape(G, group_size, 3)
    wg = vbp.reshape(G, group_size)
    denom = torch.clamp(torch.sum(wg, dim=1, keepdim=True), min=1.0)
    return torch.sum(cg * wg[..., None], dim=1) / denom


def _sweep_correction(xy, centers_k, centers_g, group_size, z0,
                      fx, fy, cx, cy, u_mid):
    """Per-event coordinate shift cancelling the packet-vs-group map error
    to first order in inverse depth, exact at the sweep midpoint `u_mid`
    (derivation in the JAX package's `_sweep_correction`)."""
    K = centers_k.shape[0]

    def coeffs(C):
        Cz = C[:, 2]
        den = z0 - Cz
        a_s = z0 / den
        b_s = -z0 * Cz / den
        kx = C[:, 0] * fx + Cz * cx
        ky = C[:, 1] * fy + Cz * cy
        return (a_s, b_s, -kx / den, kx * z0 / den, -ky / den, ky * z0 / den)

    a_s_k, b_s_k, a_tx_k, b_tx_k, a_ty_k, b_ty_k = coeffs(centers_k)
    a_s_g, b_s_g, a_tx_g, b_tx_g, a_ty_g, b_ty_g = coeffs(centers_g)

    def rep(c):
        return torch.repeat_interleave(c, group_size)[:K]

    d_as = a_s_k - rep(a_s_g)
    d_bs = b_s_k - rep(b_s_g)
    s_mid = rep(a_s_g + b_s_g * u_mid)

    X, Y = xy[..., 0], xy[..., 1]
    ax = X * d_as[:, None] + (a_tx_k - rep(a_tx_g))[:, None]
    bx = X * d_bs[:, None] + (b_tx_k - rep(b_tx_g))[:, None]
    ay = Y * d_as[:, None] + (a_ty_k - rep(a_ty_g))[:, None]
    by = Y * d_bs[:, None] + (b_ty_k - rep(b_ty_g))[:, None]
    dx = (ax + bx * u_mid) / s_mid[:, None]
    dy = (ay + by * u_mid) / s_mid[:, None]
    return dx, dy


def build_group_histograms(
    packets: WarpedPackets,
    group_size: int,
    hs: int,
    ws: int,
    pad_x: int,
    pad_y: int,
    ss: int,
    dtype: torch.dtype = torch.bfloat16,
    correction: Optional[tuple] = None,
    out_dtype: Optional[torch.dtype] = None,
    weights_binary: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear-bin each super-packet's z0 locations on the binning kernel.

    `dtype` = torch.int8 bins with int8 taps; any other `dtype` (float32
    included) bins with bf16 taps, as the JAX package's kernels do.
    `correction` = (z0, fx, fy, cx, cy, u_mid) applies the first-order sweep
    correction.  `weights_binary` asserts that the packets' explicit
    per-event weights are 0/1 (the sharded step's padding mask): the binning
    then takes its binary-weight mode, which checks them.  Events outside the
    padded grid are dropped.  Any hs: the JAX package takes its dense kernel
    where hs % 64 != 0, the same kernel here.  Returns (hist (G, hs, ws) in `out_dtype` (float32 by default),
    centers (G, 3)).
    """
    K, P, _ = packets.xy_z0.shape
    G = -(-K // group_size)
    Kp = G * group_size
    Eg = group_size * P

    centers = _group_centers(packets, group_size)

    pw = packets.event_weights().reshape(K, P)
    xy = packets.xy_z0
    if correction is not None:
        z0c, fx, fy, cx, cy, u_mid = correction
        dx, dy = _sweep_correction(
            xy, packets.centers, centers, group_size, z0c, fx, fy, cx, cy, u_mid)
        xy = torch.stack([xy[..., 0] + dx, xy[..., 1] + dy], dim=-1)

    pad_k = Kp - K
    xy = F.pad(xy, (0, 0, 0, 0, 0, pad_k))
    w = F.pad(pw, (0, 0, 0, pad_k))

    hx = ((xy[..., 0] + pad_x) * ss).reshape(G, Eg)
    hy = ((xy[..., 1] + pad_y) * ss).reshape(G, Eg)
    w = w.reshape(G, Eg)
    inb = (hx >= 0) & (hx <= ws - 1) & (hy >= 0) & (hy <= hs - 1)
    w = torch.where(inb, w, torch.zeros_like(w))
    hx = torch.clamp(hx, 0.0, ws - 1).contiguous()
    hy = torch.clamp(hy, 0.0, hs - 1).contiguous()
    # Without an explicit per-event weight (or with one the caller asserts
    # 0/1) the weights are 0/1 masks -- which the binning wrapper checks.
    hist = bin_events(hx, hy, w.contiguous(), hs=hs, ws=ws,
                      binary_w=packets.weight is None or weights_binary,
                      int8=dtype == torch.int8,
                      out_dtype=out_dtype)
    return hist, centers


def _sweep_scale_trans(centers, u, z0, fx, fy, cx, cy):
    """Eq. (15) as scale/translation in inverse depth u = 1/zi:
    X' = s(u) * X + tx(u) (y alike).  centers (N, 3), u (M,); returns
    s, tx, ty each (N, M)."""
    C = centers
    den = (z0 - C[:, 2])[:, None]
    s = z0 * (1.0 - C[:, 2:3] * u[None, :]) / den
    kx = (C[:, 0] * fx + C[:, 2] * cx)[:, None]
    ky = (C[:, 1] * fy + C[:, 2] * cy)[:, None]
    t_common = (z0 * u[None, :] - 1.0) / den
    return s, kx * t_common, ky * t_common


def _butterfly_radii(S: int) -> list:
    """Radix schedule for S segments: fewest cascade levels first, then the
    least work, smaller radices first (S=16 -> [4, 4], S=32 -> [4, 8])."""
    lv = int(np.log2(S))
    threes, rem = divmod(lv, 3)
    if rem == 1:
        threes -= 1
        twos = 2
    elif rem == 2:
        twos = 1
    else:
        twos = 0
    if threes < 0:  # lv == 1
        return [2]
    return [4] * twos + [8] * threes


def _frame_change_maps(centers_src, centers_tgt, u_mid, z0, vcam_params,
                       pad_x, pad_y, ss):
    """Bin-coordinate affine maps m = sweep_tgt(u_mid)^-1 o sweep_src(u_mid)
    taking a histogram from `centers_src`'s sweep frame into `centers_tgt`'s,
    exact at inverse depth u_mid.  Returns (s, ty, tx) each (N,)."""
    fx, fy, cx, cy = vcam_params
    u = torch.atleast_1d(torch.as_tensor(u_mid, dtype=torch.float32,
                                         device=centers_src.device))
    s_l, tx_l, ty_l = _sweep_scale_trans(centers_src, u, z0, fx, fy, cx, cy)
    s_p, tx_p, ty_p = _sweep_scale_trans(centers_tgt, u, z0, fx, fy, cx, cy)
    m_s = (s_l / s_p)[:, 0]
    m_tx = ((tx_l - tx_p) / s_p)[:, 0]
    m_ty = ((ty_l - ty_p) / s_p)[:, 0]
    bt_x = ss * (m_tx + pad_x * (1.0 - m_s))
    bt_y = ss * (m_ty + pad_y * (1.0 - m_s))
    return m_s, bt_y, bt_x


def merge_leaf_histograms(hist, centers, merge, u_mid, z0, vcam_params,
                          pad_x, pad_y, ss, dtype=torch.bfloat16):
    """The flat merge: groups of `merge` adjacent leaf histograms summed into
    supergroups, each leaf resampled from its own sweep frame into the
    supergroup center's, exact at inverse depth `u_mid` -- one
    `banded_resample_sum(blocked=True)` call.  Returns (hist_super
    (G/merge, hs, ws), bf16 when `dtype` is, else float32; centers_super
    (G/merge, 3))."""
    G, hs_, ws_ = hist.shape
    P = -(-G // merge)
    pad_g = P * merge - G
    if pad_g:
        hist = F.pad(hist, (0, 0, 0, 0, 0, pad_g))
        centers = torch.cat([centers, centers[-1:].expand(pad_g, 3)])
    centers_super = torch.mean(centers.reshape(P, merge, 3), dim=1)
    m_s, bt_y, bt_x = _frame_change_maps(
        centers, torch.repeat_interleave(centers_super, merge, dim=0), u_mid, z0,
        vcam_params, pad_x, pad_y, ss)
    s = m_s.reshape(P, merge)
    # The scales are frame changes between camera centers millimetres apart,
    # so they stay within 1e-3 of 1 on real rigs, inside the 0.8 bound
    # (scale_min) under which both JAX engines take this resample; kernel B
    # holds for any scale.
    out = banded_resample_sum(
        hist, s, bt_y.reshape(P, merge), s, bt_x.reshape(P, merge), out_h=hs_,
        out_w=ws_, blocked=True,
        out_dtype=dtype if dtype == torch.bfloat16 else None)
    return out, centers_super


def _merge_butterfly(hist, centers, depths, bounds, z0, vcam_params,
                     pad_x, pad_y, ss, dtype=torch.bfloat16):
    """Hierarchical merge of leaf histograms (the fast-slant-stack
    butterfly).  At each level of radix r, r-tuples of adjacent groups merge
    into a node at their mean camera center while the inverse-depth range
    splits r ways.  Returns (hist_per_segment (S, G/S, hs, ws),
    centers (G/S, 3))."""
    S = len(bounds) - 1
    G0, hs_, ws_ = hist.shape
    pad_g = -G0 % S
    if pad_g:
        hist = F.pad(hist, (0, 0, 0, 0, 0, pad_g))
        centers = torch.cat([centers, centers[-1:].expand(pad_g, 3)])
    G = hist.shape[0]

    radii = _butterfly_radii(S)

    def block_umid(splits, r):
        """u-midpoint of range r of `splits` (covers S/splits segments)."""
        per = S // splits
        i0, i1 = bounds[r * per], bounds[(r + 1) * per]
        if i1 <= i0:
            i0, i1 = max(i0 - 1, 0), i0 + 1
        u = 1.0 / depths[i0:i1]
        return 0.5 * (torch.min(u) + torch.max(u))

    cur = hist.to(dtype)                   # (R*N, hs, ws), R=1, N=G
    cen = centers                          # (N, 3), shared across ranges
    R, N = 1, G
    splits = 1
    for radix in radii:
        R_prev, N_prev = R, N
        R, N = radix * R_prev, N_prev // radix
        splits *= radix
        tgt = torch.mean(cen.reshape(N, radix, 3), dim=1)        # (N, 3)
        tgt_rep = torch.repeat_interleave(tgt, radix, dim=0)     # (N_prev, 3)

        sys_, tys_, txs_ = [], [], []
        for r in range(R):
            m_s, bt_y, bt_x = _frame_change_maps(
                cen, tgt_rep, block_umid(splits, r), z0, vcam_params,
                pad_x, pad_y, ss)
            sys_.append(m_s)
            tys_.append(bt_y)
            txs_.append(bt_x)

        if radix >= _FANIN_MIN_RADIX:
            Ngrp = R_prev * N

            def fanin_build(R_prev=R_prev, N=N, radix=radix, Ngrp=Ngrp):
                # Group (q, n) = (parent range, node) holds its radix parents
                # (q*N_prev + radix*n + k) and produces its radix child ranges
                # j, each written to standard index (q*radix + j)*N + n.
                qs = np.arange(R_prev)[:, None, None]
                ns = np.arange(N)[None, :, None]
                js = np.arange(radix)[None, None, :]
                out_idx = ((qs * radix + js) * N + ns).reshape(Ngrp, radix)
                return fanin_tables(out_idx, radix, radix * Ngrp)

            items = cached_items(("butterfly-fanin", R_prev, N, radix), hist.device,
                                 fanin_build)

            def fanin_maps(parts):
                a = torch.cat(parts).reshape(R_prev, radix, N, radix)
                return a.permute(0, 2, 1, 3).reshape(Ngrp, radix, radix).contiguous()

            cur = banded_resample_fanin(
                cur.reshape(Ngrp, radix, hs_, ws_),
                fanin_maps(sys_), fanin_maps(tys_),
                fanin_maps(sys_), fanin_maps(txs_),
                items, n_out=R * N, out_h=hs_, out_w=ws_, out_dtype=dtype)
        else:
            def sum_build(R=R, N=N, N_prev=N_prev, radix=radix):
                # Child (r, n) gathers its radix parents from range r // radix.
                rs = np.arange(R)[:, None, None]
                ns = np.arange(N)[None, :, None]
                ks = np.arange(radix)[None, None, :]
                return sum_tables(((rs // radix) * N_prev + radix * ns + ks).reshape(
                    R * N, radix))

            items = cached_items(("butterfly-sum", R, N, N_prev, radix), hist.device,
                                 sum_build)
            NK = R * N
            sy = torch.cat(sys_).reshape(NK, radix)
            ty = torch.cat(tys_).reshape(NK, radix)
            tx = torch.cat(txs_).reshape(NK, radix)
            cur = banded_resample_sum(
                cur, sy, ty, sy, tx, out_h=hs_, out_w=ws_, blocked=True,
                src=items, out_dtype=dtype)
        cen = tgt
    return cur.reshape(R, N, hs_, ws_), cen


def segment_bounds_equal_u(depths: np.ndarray, segments: int) -> Tuple[int, ...]:
    """Plane-index boundaries splitting the sweep into `segments` chunks of
    approximately equal inverse-depth span; a (segments+1)-tuple."""
    d = np.asarray(depths, np.float64)
    u = 1.0 / d
    targets = np.linspace(u[0], u[-1], segments + 1)
    sign = 1.0 if u[-1] >= u[0] else -1.0
    idx = [0]
    for k in range(1, segments):
        pos = int(np.searchsorted(sign * u, sign * targets[k]))
        idx.append(int(np.clip(pos, idx[-1] + 1, len(u) - (segments - k))))
    idx.append(len(u))
    return tuple(idx)


def _affine_coeffs(centers, depths, z0, fx, fy, cx, cy, pad_x, pad_y, ss):
    """Per (group, plane) separable affine map from histogram-bin index to
    output pixel, x_out = p * sx + tx (y alike), from Eq. (15) with bin p at
    X = p/ss - pad_x.  Returns sx, tx, sy, ty each (G, Z)."""
    C = centers
    zi = depths[None, :]
    a = z0 * (zi - C[:, 2:3])
    bx = (z0 - zi) * (C[:, 0:1] * fx + C[:, 2:3] * cx)
    by = (z0 - zi) * (C[:, 1:2] * fy + C[:, 2:3] * cy)
    d = zi * (z0 - C[:, 2:3])
    d = torch.where(torch.abs(d) < 1e-12, torch.full_like(d, 1e-12), d)
    sx = a / (d * ss)
    tx = (bx - pad_x * a) / d
    sy = a / (d * ss)
    ty = (by - pad_y * a) / d
    return sx, tx, sy, ty


def _sweep_planes_fanin(hist_seg, centers_s, depths, bounds, z0, vcam_params,
                        width, height, pad_x, pad_y, ss):
    """Plane sweep over the butterfly's range-specialized supergroups: one
    fan-in call sweeps every segment; ragged segments are padded with
    clamped duplicate plane indices, which the fan-in wrapper writes once."""
    fx, fy, cx, cy = vcam_params
    Z = depths.shape[0]
    sx, tx, sy, ty = _affine_coeffs(
        centers_s, depths, z0, fx, fy, cx, cy, pad_x, pad_y, ss)  # (K, Z)
    K = centers_s.shape[0]
    items = cached_items(("sweep-fanin", tuple(bounds), K), depths.device,
                         lambda: fanin_tables(_plane_rows(bounds), K, Z))
    pidx_t = cached_index(("sweep-planes", tuple(bounds)), depths.device,
                          lambda: _plane_rows(bounds))

    def gath(c):  # (K, Z) -> (S, M, K)
        return c[:, pidx_t].permute(1, 2, 0).contiguous()

    return banded_resample_fanin(
        hist_seg, gath(sy), gath(ty), gath(sx), gath(tx), items,
        n_out=Z, out_h=height, out_w=width)


def _plane_rows(bounds) -> np.ndarray:
    """(S, M) plane indices of each segment, M its longest, padded with the
    segment's last plane (the fan-in writes each plane once)."""
    S = len(bounds) - 1
    M = max(bounds[s + 1] - bounds[s] for s in range(S))
    return np.stack([np.minimum(bounds[s] + np.arange(M), bounds[s + 1] - 1)
                     for s in range(S)])


def _sweep_planes(hist, centers, depths, z0, vcam_params, width, height,
                  pad_x, pad_y, ss):
    """The non-segmented sweep: DSI[zi] = sum_g resample(hist[g],
    map[g, zi]) for every plane, one `banded_resample_sum(blocked=False)`
    call.  The TPU kernel's `tile_v`/`scale_min` have no counterpart: the
    CUDA kernel is exact for any scale.  Returns (Z, height, width) float32."""
    fx, fy, cx, cy = vcam_params
    sx, tx, sy, ty = _affine_coeffs(
        centers, depths, z0, fx, fy, cx, cy, pad_x, pad_y, ss)  # (G, Z)
    return banded_resample_sum(hist, sy.T, ty.T, sx.T, tx.T, out_h=height,
                               out_w=width, blocked=False)


def splat_hist(
    packets: WarpedPackets,
    depths: torch.Tensor,
    z0: float,
    vcam_params: Tuple[float, float, float, float],
    width: int,
    height: int,
    plane_block: int = 8,
    group_size: int = 32,
    supersample: int = SUPERSAMPLE,
    pad_x: int = PAD_X,
    pad_y: int = PAD_Y,
    dtype: torch.dtype = torch.bfloat16,
    correct: bool = True,
    segments: int = 1,
    seg_bounds: Optional[Tuple[int, ...]] = None,
    bin_dtype: Optional[torch.dtype] = None,
    engine: str = "xla",
    merge_mode: str = "flat",
    corr_u_mid=None,
    weights_binary: bool = False,
) -> torch.Tensor:
    """Vote all packets into a (Z, H, W) float32 DSI by histogram + affine
    resample on the kernels, as the JAX package's `engine` ("xla" or
    "pallas") does it.

    `group_size` packets share one camera center; `pad_x`/`pad_y` extend the
    z0 grid; `supersample` refines it; `dtype` (bf16 or float32) is the type
    of the histograms and merge levels, `bin_dtype` (torch.int8 for int8
    taps) overrides it for binning; `correct=False` drops the sweep
    correction.  `segments` > 1 splits the inverse-depth sweep into
    segments and merges the leaf histograms per segment, flat
    (`merge_mode="flat"`) or by the O(G log S) butterfly (`"butterfly"`,
    power-of-two segments, "pallas" only); 1 sweeps every plane over all
    leaves.  `seg_bounds` gives the segments' plane boundaries, a
    (segments + 1)-tuple from 0 to Z (equal plane counts when None; see
    `segment_bounds_equal_u`); a segment may be empty.  When `segments`
    exceeds the planes present (a plane-sharded z-block) it is clamped and
    the bounds fall back to equal counts.

    The sharded step passes two more: `corr_u_mid`, the inverse depth at
    which the sweep correction is exact (by default the midpoint of these
    planes; a plane block passes the whole sweep's, so every block bins as
    the single-device run does), and `weights_binary`, which asserts that
    the packets' explicit weights are 0/1 (`build_group_histograms`).
    `plane_block` is accepted for the backend signature and unused.
    """
    del plane_block
    if engine not in ("xla", "pallas"):
        raise ValueError(f"engine must be 'xla' or 'pallas', got {engine!r}")
    fx, fy, cx, cy = vcam_params
    ss = supersample
    hs = (height + 2 * pad_y) * ss
    ws = (width + 2 * pad_x) * ss
    if engine == "pallas":
        # The Pallas engine's aligned grid (extra bins at the right/bottom
        # edge are never mapped); kept so both packages bin on the same grid.
        ws += -ws % 128
        hs += -hs % 64
    Z = depths.shape[0]

    if corr_u_mid is None:
        u_all = 1.0 / depths
        corr_u_mid = 0.5 * (torch.min(u_all) + torch.max(u_all))
    corr = (z0, fx, fy, cx, cy, corr_u_mid) if correct else None
    hist, centers = build_group_histograms(
        packets, group_size, hs, ws, pad_x, pad_y, ss,
        dtype=bin_dtype if bin_dtype is not None else dtype,
        correction=corr, out_dtype=dtype, weights_binary=weights_binary)

    if segments > 1:
        # Clamp the segment count to the planes present (the butterfly's to
        # a power of two); clamped bounds are equal counts again.
        eff = min(segments, Z)
        if merge_mode == "butterfly":
            eff = 1 << (eff.bit_length() - 1)
        if eff != segments:
            segments, seg_bounds = eff, None
    if segments <= 1:
        return _sweep_planes(hist, centers, depths, z0, vcam_params, width,
                             height, pad_x, pad_y, ss)
    if seg_bounds is None:
        bounds = [round(s * Z / segments) for s in range(segments + 1)]
    else:
        bounds = list(seg_bounds)
        if len(bounds) != segments + 1 or bounds[0] != 0 or bounds[-1] != Z or any(
                b1 < b0 for b0, b1 in zip(bounds, bounds[1:])):
            raise ValueError(f"seg_bounds must rise from 0 to {Z} in {segments} steps, "
                             f"got {seg_bounds}")
    live = [s for s in range(segments) if bounds[s] < bounds[s + 1]]
    if merge_mode == "butterfly":
        if engine != "pallas":
            raise ValueError("merge_mode='butterfly' needs the pallas engine (spec token "
                             f"'pl'), got {engine!r}")
        hist_seg, centers_s = _merge_butterfly(
            hist, centers, depths, bounds, z0, vcam_params, pad_x, pad_y, ss, dtype)
        if len(live) == segments:
            return _sweep_planes_fanin(
                hist_seg, centers_s, depths, bounds, z0, vcam_params,
                width, height, pad_x, pad_y, ss)
        # An empty segment: the fan-in's padded index rows need every
        # segment to hold a plane, so each live one sweeps on its own.
        return torch.cat([_sweep_planes(
            hist_seg[s], centers_s, depths[bounds[s]:bounds[s + 1]], z0, vcam_params,
            width, height, pad_x, pad_y, ss) for s in live])
    parts = []
    for s in live:
        dseg = depths[bounds[s]:bounds[s + 1]]
        useg = 1.0 / dseg
        hist_s, centers_s = merge_leaf_histograms(
            hist, centers, segments, 0.5 * (torch.min(useg) + torch.max(useg)),
            z0, vcam_params, pad_x, pad_y, ss, dtype)
        parts.append(_sweep_planes(hist_s, centers_s, dseg, z0,
                                   vcam_params, width, height, pad_x, pad_y, ss))
    return torch.cat(parts)


def auto_group_size(
    travel_m: float,
    num_packets: int,
    fx: float,
    min_depth: float,
    max_depth: float,
    tol_px: float = 1.0,
    corrected: bool = True,
) -> int:
    """Largest power-of-two packet grouping keeping the grouping error under
    `tol_px` at the depth-sweep extremes (capped at 1024)."""
    if num_packets <= 1 or travel_m <= 0:
        return max(1, num_packets)
    sens = fx * abs(1.0 / min_depth - 1.0 / max_depth)
    corr_gain = 4.0 if corrected else 2.0
    spread_tol = corr_gain * tol_px / max(sens, 1e-9)
    per_packet = travel_m / num_packets
    g = max(1, int(spread_tol / max(per_packet, 1e-12)))
    return 1 << min(int(g).bit_length() - 1, 10)


def auto_backend_spec(
    chunk_travel_m: float,
    n_packets: int,
    fx: float,
    min_depth: float,
    max_depth: float,
    dim_z: int,
) -> str:
    """The production backend spec on the kernel engine, the string the JAX
    package's CLI selects for its kernel engine: travel-bounded group size,
    a power-of-two segment count capped at 16, butterfly merge."""
    g = auto_group_size(chunk_travel_m, n_packets, fx, min_depth, max_depth)
    spec = f"hist:g{g}"
    segs = min(16, dim_z // 10)
    if segs >= 2:
        segs = min(16, 1 << (segs - 1).bit_length())
        spec += f",seg{segs},bf"
    return spec + ",pl"


def make_hist_backend(group_size: int = 32, supersample: int = SUPERSAMPLE,
                      pad_x: int = PAD_X, pad_y: int = PAD_Y,
                      dtype: torch.dtype = torch.bfloat16, correct: bool = True,
                      segments: int = 1,
                      seg_bounds: Optional[Tuple[int, ...]] = None,
                      bin_dtype: Optional[torch.dtype] = None,
                      engine: str = "xla", merge_mode: str = "flat"):
    """A backend callable (the `splat_scatter` signature) with fixed knobs."""
    return functools.partial(
        splat_hist, group_size=group_size, supersample=supersample,
        pad_x=pad_x, pad_y=pad_y, dtype=dtype, correct=correct,
        segments=segments, seg_bounds=seg_bounds, bin_dtype=bin_dtype,
        engine=engine, merge_mode=merge_mode)
