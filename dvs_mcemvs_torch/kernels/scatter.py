"""The exact vote: the CUDA kernels (csrc/scatter.cu) and their plain
PyTorch versions.

For every event e of packet k = e // P, with z0 location (x, y) and flat
weight w, and every plane z of a (K, Z) table of Eq. 15 coefficients
(a, bx, by, d) = coef[k, z]:

    X = (x * a + bx) / d,    Y = (y * a + by) / d

and, where 0 <= X < W - 1 and 0 <= Y < H - 1, the four bilinear taps of
(X, Y), each times w, are added into plane z of a (Z, H, W) float32 DSI.
Both versions round each operation once in float32, in this order, so a
tap's index and weight agree to the bit and only the order of the sums
differs.  Weights are finite.

On the card the vote is gathered by output tile (`vote_params` sizes it):
the bin pass sorts the events by (group of packets, z0 cell)
(`bin_events`; plain version `bin_events_reference`), the plan gives each
(slab, group, tile) the cells whose events can tap it (`plan`; plain
version `vote_plan`), and the vote pass sums each tile of a slab of planes
in shared memory and stores it once.  `scatter_vote_reference` is the plain
version of the whole vote and the CPU path.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Tuple

import torch

from .. import tracing
from . import _build

_c_void_p, _c_int, _c_float, _c_double = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                                          ctypes.c_double)
# Events a launch (32-bit indices).
MAX_EVENTS = 2**31 - 1024
# (group, cell row) segments a batch of the vote pass (csrc/scatter.cu:
# kSegments): a cell grid has at most this many rows.
SEGMENTS = 1024
# Shared memory a block may take on an H100 (its 228 KB an SM less the 1 KB
# reserved a block; the vote pass runs one block of 1024 threads an SM),
# and what a vote block takes besides its tile: the segment arrays, the
# scan's and the counters' words.
SMEM_PER_BLOCK = 227 << 10
VOTE_STATIC_SMEM = 2 * SEGMENTS * 4 + 32 * 4 + 3 * 8
# Tile sides, the most planes a slab, events a packet group and the most
# cells a grid may have (the bin pass's counters and offsets a group).
TILE_W, TILE_H = 128, 128
MAX_SLAB = 16
GROUP_EVENTS = 1 << 17
MAX_CELLS = 32768
# The cell grid reaches past the image by this share of its larger side
# (whole cells): z0 locations there are common (a camera's overscan), and
# past the grid they share its border cells.
BORDER_SHARE = 1 / 8
# The plan's margin: 1 px plus this share of the magnitudes that enter the
# forward map, far above float32's rounding (2**-24 an operation).
MARGIN_REL = 2.0**-12
# The counters of the vote pass (`vote_counters`).
COUNTER_NAMES = ("visits", "hits", "fallbacks")


def _library() -> ctypes.CDLL:
    lib = _build.load("scatter")
    if "scatter_tiles" in vars(lib):  # argtypes already set on this library
        return lib
    lib.scatter_bin.argtypes = ([_c_void_p] * 5 + [_c_int] * 3 + [_c_float] * 2
                                + [_c_int] * 2 + [_c_void_p])
    lib.scatter_bin.restype = _c_int
    lib.scatter_tiles.argtypes = [_c_void_p] * 8 + [_c_int] * 11 + [_c_void_p]
    lib.scatter_tiles.restype = _c_int
    lib.scatter_plan.argtypes = [_c_void_p] * 5 + [_c_int] * 12 + [_c_double, _c_void_p]
    lib.scatter_plan.restype = _c_int
    return lib


def bilinear_corners(xf: torch.Tensor, yf: torch.Tensor, width: int, height: int):
    """4-corner flat indices (y*W+x) and weights of the reference splat.  A
    vote is in bounds where 0 <= x < width - 1 and 0 <= y < height - 1,
    decided on the float coordinates, so NaN and +-inf are out; out-of-bounds
    votes get weight 0 and index 0."""
    inb = (xf >= 0) & (xf < width - 1) & (yf >= 0) & (yf < height - 1)
    xf = torch.where(inb, xf, 0.0)
    yf = torch.where(inb, yf, 0.0)
    x0 = torch.floor(xf).to(torch.int64)
    y0 = torch.floor(yf).to(torch.int64)
    fx = xf - x0.to(xf.dtype)
    fy = yf - y0.to(yf.dtype)
    w00 = (1 - fx) * (1 - fy)
    w10 = fx * (1 - fy)
    w01 = (1 - fx) * fy
    w11 = fx * fy
    base = y0 * width + x0
    idx4 = torch.stack([base, base + 1, base + width, base + width + 1], dim=-1)
    w4 = torch.stack([w00, w10, w01, w11], dim=-1)
    w4 = torch.where(inb[..., None], w4, torch.zeros_like(w4))
    return idx4, w4


def scatter_vote_reference(xy: torch.Tensor, pw: torch.Tensor, coef: torch.Tensor,
                           width: int, height: int, plane_block: int = 8) -> torch.Tensor:
    """Plain version: per block of `plane_block` planes, the coefficients
    repeated per event, the corners of `bilinear_corners`, then one
    `index_add_` a plane.  Returns the (Z, H, W) float32 DSI."""
    E = xy.shape[0]
    K, Z, _ = coef.shape
    P = E // K if K else 0
    out = torch.zeros((Z, height * width), dtype=torch.float32, device=xy.device)
    for z_lo in range(0, Z if E else 0, plane_block):
        sl = slice(z_lo, min(z_lo + plane_block, Z))
        a, bx, by, d = (coef[:, sl, i].T.repeat_interleave(P, dim=1) for i in range(4))
        X = (xy[None, :, 0] * a + bx) / d                          # (ZB, E)
        Y = (xy[None, :, 1] * a + by) / d
        idx4, w4 = bilinear_corners(X, Y, width, height)           # (ZB, E, 4)
        w4 = w4 * pw[None, :, None]
        blk = out[sl]
        for zb in range(blk.shape[0]):
            blk[zb].index_add_(0, idx4[zb].reshape(-1), w4[zb].reshape(-1))
    return out.reshape(Z, height, width)


class VoteParams(NamedTuple):
    """The gather's sizes: a tile of `tile_w` x `tile_h` voxels and `slab`
    planes a block, packets of `group` a bin group, z0 cells of `cell` px
    (a power of two) on a grid that starts `border` px (whole cells) before
    the image on both axes and ends as far past it, and the floats a tile
    row takes in shared memory."""

    tile_w: int
    tile_h: int
    slab: int
    group: int
    cell: int
    border: int
    pitch: int


def _even(n: int, most: int) -> int:
    """At most `most` (at least 1) a part, evened out over the parts that n
    needs."""
    parts = -(-n // max(1, min(most, n)))
    return -(-n // parts)


def row_pitch(tile_w: int) -> int:
    """Floats a tile row takes in shared memory: tile_w and up to 5 (mod
    32), so that the voxels of a column, a row or a diagonal fall in
    distinct banks (128-float rows put a column in one bank: 5-20 % slower
    on the cells' packets)."""
    return tile_w + (5 - tile_w) % 32


def vote_params(Z: int, height: int, width: int, K: int, P: int,
                smem: int = SMEM_PER_BLOCK) -> VoteParams:
    """The gather's sizes for K packets of P events voted into a (Z, height,
    width) DSI on a card whose blocks may take `smem` shared bytes: tiles of
    TILE_W x TILE_H (the image's side where smaller; fewer rows where one
    plane of the tile would not fit), as many planes a slab as fit the
    block's shared memory (at most MAX_SLAB, evened out over the slabs),
    GROUP_EVENTS events a group (whole packets, at least one), and 16 px
    cells, doubled until the grid, BORDER_SHARE of the image's larger side
    past each edge, has at most MAX_CELLS cells and SEGMENTS rows."""
    tile_w = min(TILE_W, width)
    pitch = row_pitch(tile_w)
    budget = smem - VOTE_STATIC_SMEM
    tile_h = max(1, min(TILE_H, height, budget // (4 * pitch)))
    slab = _even(Z, min(MAX_SLAB, budget // (4 * pitch * tile_h)))
    group = max(1, min(K, GROUP_EVENTS // max(P, 1)))
    cell = 8
    while True:
        cell *= 2
        border = cell * -int(-max(width, height) * BORDER_SHARE // cell)
        cw, ch = -(-(width + 2 * border) // cell), -(-(height + 2 * border) // cell)
        if cw * ch <= MAX_CELLS and ch <= SEGMENTS:
            return VoteParams(tile_w, tile_h, slab, group, cell, border, pitch)


def grid_shape(params: VoteParams, K: int, Z: int, height: int, width: int) -> Dict[str, int]:
    """The counts that `params` gives: groups, slabs, tile columns and rows,
    cell columns and rows."""
    p = params
    return dict(groups=-(-K // p.group), slabs=-(-Z // p.slab), tiles_x=-(-width // p.tile_w),
                tiles_y=-(-height // p.tile_h), cells_x=-(-(width + 2 * p.border) // p.cell),
                cells_y=-(-(height + 2 * p.border) // p.cell))


def bin_events_reference(xy: torch.Tensor, pw: torch.Tensor, P: int, params: VoteParams,
                         width: int, height: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the bin pass: each group of `params.group` packets'
    events with a weight and a finite z0 location, by cell (the cell of
    floor((location + border) / cell), clamped to the grid), in event order
    within a cell.  Returns binned, (E, 4) float32 rows (x, y, w, packet index as
    int32 bits) with each group's events from its first index on and zeros
    past them, and off, (groups, cells + 1) int32: each (group, cell)'s
    first binned index, then the group's end."""
    E = xy.shape[0]
    g = grid_shape(params, max(E // max(P, 1), 1), 1, height, width)
    cw, ch = g["cells_x"], g["cells_y"]
    ge = params.group * P
    groups = -(-E // ge) if E else 0
    e = torch.arange(E, device=xy.device)
    keep = (pw != 0) & torch.isfinite(xy).all(1)
    c = torch.floor((torch.where(keep[:, None], xy, 0.0) + params.border) / params.cell)
    c = c[:, 1].clamp(0, ch - 1).long() * cw + c[:, 0].clamp(0, cw - 1).long()
    key = torch.where(keep, (e // ge) * (cw * ch) + c, groups * cw * ch)
    order = torch.sort(key, stable=True).indices[:int(keep.sum())]
    counts = torch.bincount(key[keep], minlength=groups * cw * ch).reshape(groups, cw * ch)
    first = torch.arange(groups, device=xy.device)[:, None] * ge
    off = torch.cat([torch.zeros_like(counts[:, :1]), counts.cumsum(1)], 1) + first
    per_group = counts.sum(1)
    at = (e[:order.shape[0]] - torch.repeat_interleave(
        torch.cat([torch.zeros(1, dtype=torch.long, device=xy.device),
                   per_group.cumsum(0)[:-1]]), per_group)
          + torch.repeat_interleave(first[:, 0], per_group))
    binned = torch.zeros((E, 4), dtype=torch.float32, device=xy.device)
    k = (order // P).to(torch.int32).view(torch.float32)
    binned[at] = torch.stack([xy[order, 0], xy[order, 1], pw[order], k], 1)
    return binned, off.to(torch.int32)


def vote_plan(coef: torch.Tensor, params: VoteParams, width: int, height: int):
    """The cells each vote block visits, for the (K, Z, 4) Eq. 15 table
    `coef`: for every (slab, group, tile column), the first and last cell
    column whose events can tap the column's voxels in a plane of the slab,
    and for every tile row the cell rows; (xr (slabs, groups, tiles_x, 2),
    yr (slabs, groups, tiles_y, 2), fb (slabs, groups)), int32 on coef's
    device.

    A packet maps z0 to plane z by X = x * a / d + bx / d, so X's range
    [tx0 - 1, tx1] (the taps of x0 = floor(X) and x0 + 1 reach the tile's
    columns [tx0, tx1)) comes from x = s * (X - c) + u with s = d / a and
    u = s * c - bx / a, c the image's middle.  Per (group, plane), s and u
    are bounded over the group's packets and x over the corners of s and
    X; the margin (1 px plus MARGIN_REL of the magnitudes) keeps every
    location whose float32 transfer lands in range.  A group with a = 0,
    d = 0 or a coefficient, s or u not finite in a plane of the slab falls
    back to every cell (fb = 1).  Float64 throughout; a floor and a clamp
    to the grid, as the bin pass clamps."""
    K, Z, _ = coef.shape
    g = grid_shape(params, K, Z, height, width)
    G, NS, gs, zs = g["groups"], g["slabs"], params.group, params.slab
    dev = coef.device
    f64 = dict(dtype=torch.float64, device=dev)
    kk = torch.arange(G * gs, device=dev).clamp_(max=K - 1)   # a repeat moves no bound
    zz = torch.arange(NS * zs, device=dev).clamp_(max=Z - 1)
    a, bx, by, d = coef.to(torch.float64)[kk][:, zz].unbind(-1)       # (G*gs, NS*zs)
    s = d / a
    axis = torch.arange(2, **f64)   # x, y: made on the device, as a capture allows

    def pair(x: float, y: float) -> torch.Tensor:
        return x + (y - x) * axis

    mid = pair(width / 2, height / 2)
    u = s[..., None] * mid - torch.stack([bx, by], -1) / a[..., None]  # (.., 2)
    bad = ~(torch.isfinite(s) & torch.isfinite(u).all(-1)) | (a == 0) | (d == 0)
    bad = bad.reshape(G, gs, NS, zs).any(3).any(1)                      # (G, NS)
    s = torch.nan_to_num(s).reshape(G, gs, NS * zs)
    u = torch.nan_to_num(u).reshape(G, gs, NS * zs, 2)
    s_lo, s_hi = s.amin(1)[..., None, None], s.amax(1)[..., None, None]  # (G, Zp, 1, 1)
    u_lo, u_hi = u.amin(1)[..., None], u.amax(1)[..., None]             # (G, Zp, 2, 1)
    n = max(g["tiles_x"], g["tiles_y"])
    j = torch.arange(n, **f64)
    tile = pair(params.tile_w, params.tile_h)[:, None]
    top = pair(width - 1, height - 1)[:, None]
    X_lo = (j * tile - 1).clamp(min=0) - mid[:, None]                   # (2, n)
    X_hi = torch.minimum((j + 1) * tile, top) - mid[:, None]
    ends = torch.stack([s_lo * X_lo, s_lo * X_hi, s_hi * X_lo, s_hi * X_hi])
    mag = (torch.maximum(s_lo.abs(), s_hi.abs())
           * (torch.maximum(X_lo.abs(), X_hi.abs()) + 2 * mid[:, None] + top)
           + torch.maximum(u_lo.abs(), u_hi.abs()))
    margin = 1.0 + MARGIN_REL * mag
    lo = (ends.amin(0) + u_lo - margin).reshape(G, NS, zs, 2, n).amin(2)
    hi = (ends.amax(0) + u_hi + margin).reshape(G, NS, zs, 2, n).amax(2)
    last = pair(g["cells_x"] - 1, g["cells_y"] - 1)[:, None]
    lo = torch.minimum(torch.floor((lo + params.border) / params.cell).clamp(min=0), last)
    hi = torch.minimum(torch.floor((hi + params.border) / params.cell).clamp(min=0), last)
    full = bad[..., None, None]
    lo = torch.where(full, 0.0, lo)
    hi = torch.where(full, last, hi)
    r = torch.stack([lo, hi], -1).to(torch.int32).transpose(0, 1)       # (NS, G, 2, n, 2)
    return (r[:, :, 0, :g["tiles_x"]].contiguous(), r[:, :, 1, :g["tiles_y"]].contiguous(),
            bad.T.to(torch.int32).contiguous())


_COUNTS: Dict[torch.device, torch.Tensor] = {}
_COUNTS_LOCK = threading.Lock()


def _counts(dev: torch.device):
    """The device's counter buffer (3 int64, zeroed once, outside any
    capture), or None inside a capture before any call outside one made it:
    that graph counts nothing."""
    with _COUNTS_LOCK:
        buf = _COUNTS.get(dev)
        if buf is None and not torch.cuda.is_current_stream_capturing():
            buf = _COUNTS[dev] = torch.zeros(len(COUNTER_NAMES), dtype=torch.int64, device=dev)
        return buf


def vote_counters() -> Dict[str, int]:
    """The vote pass's counters, summed over devices since the process
    started: event-planes visited, event-planes with a tap in the block's
    tile, and (block, group) pairs that visited every cell.  Reads each
    device's buffer (a device sync): not for the hot path."""
    with _COUNTS_LOCK:
        bufs = list(_COUNTS.values())
    total = [0] * len(COUNTER_NAMES)
    for buf in bufs:
        total = [t + v for t, v in zip(total, buf.tolist())]
    return dict(zip(COUNTER_NAMES, total))


def bin_events(xy: torch.Tensor, pw: torch.Tensor, P: int, params: VoteParams, width: int,
               height: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bin pass on the card (csrc/scatter.cu: bin_count, bin_scan and
    bin_scatter), on the current stream: `bin_events_reference`'s (binned,
    off), with the events of a cell in any order and the rows past each
    group's events left unwritten."""
    E = xy.shape[0]
    dev = xy.device
    g = grid_shape(params, max(E // P, 1), 1, height, width)
    cw, ch = g["cells_x"], g["cells_y"]
    groups = -(-E // (params.group * P))
    binned = torch.empty((E, 4), dtype=torch.float32, device=dev)
    off = torch.empty((groups, cw * ch + 1), dtype=torch.int32, device=dev)
    count = torch.empty((groups, cw * ch), dtype=torch.int32, device=dev)
    _build.check(_library().scatter_bin(
        xy.data_ptr(), pw.data_ptr(), binned.data_ptr(), off.data_ptr(), count.data_ptr(), E, P,
        params.group * P, 1.0 / params.cell, float(params.border), cw, ch,
        torch.cuda.current_stream(dev).cuda_stream), "scatter_bin")
    return binned, off


def plan(coef: torch.Tensor, params: VoteParams, width: int, height: int):
    """The plan on the card (csrc/scatter.cu: plan_bounds and plan_cells),
    on the current stream: `vote_plan`'s (xr, yr, fb), in the same float64
    operations."""
    K, Z, _ = coef.shape
    g = grid_shape(params, K, Z, height, width)
    dev = coef.device
    xr = torch.empty((g["slabs"], g["groups"], g["tiles_x"], 2), dtype=torch.int32, device=dev)
    yr = torch.empty((g["slabs"], g["groups"], g["tiles_y"], 2), dtype=torch.int32, device=dev)
    fb = torch.empty((g["slabs"], g["groups"]), dtype=torch.int32, device=dev)
    bounds = torch.empty((g["groups"], Z, 7), dtype=torch.float64, device=dev)
    _build.check(_library().scatter_plan(
        coef.data_ptr(), xr.data_ptr(), yr.data_ptr(), fb.data_ptr(), bounds.data_ptr(), K, Z,
        height, width, params.tile_w, params.tile_h, params.slab, params.group, params.cell,
        params.border, g["cells_x"], g["cells_y"], MARGIN_REL,
        torch.cuda.current_stream(dev).cuda_stream), "scatter_plan")
    return xr, yr, fb


def scatter_vote(xy: torch.Tensor, pw: torch.Tensor, coef: torch.Tensor, *,
                 width: int, height: int, plane_block: int = 8) -> torch.Tensor:
    """Vote E events into a fresh (Z, height, width) float32 DSI.

    xy: (E, 2) z0 locations; pw: (E,) flat weights (packet validity times
    the event's weight); coef: (K, Z, 4) Eq. 15 coefficients (a, bx, by, d)
    of each packet and plane, E = K * P; all float32 and contiguous.  A CPU
    tensor runs the plain version (`plane_block` planes at a time); a CUDA
    tensor runs the plan, the bin pass and the vote pass of csrc/scatter.cu
    on the current stream with `vote_params`' sizes, counted as one launch,
    unless there is nothing to vote."""
    if xy.ndim != 2 or xy.shape[1] != 2:
        raise ValueError(f"xy must be (E, 2), got {tuple(xy.shape)}")
    E = xy.shape[0]
    if tuple(pw.shape) != (E,):
        raise ValueError(f"pw must be ({E},), got {tuple(pw.shape)}")
    if coef.ndim != 3 or coef.shape[2] != 4:
        raise ValueError(f"coef must be (K, Z, 4), got {tuple(coef.shape)}")
    K, Z, _ = coef.shape
    if E and (K == 0 or E % K):
        raise ValueError(f"{E} events do not fill {K} packets evenly")
    if E > MAX_EVENTS:
        raise ValueError(f"{E} events exceed the kernel's {MAX_EVENTS}")
    if any(t.dtype != torch.float32 for t in (xy, pw, coef)):
        raise TypeError("xy, pw, coef must be float32")
    if not (xy.is_contiguous() and pw.is_contiguous() and coef.is_contiguous()):
        raise ValueError("xy, pw, coef must be contiguous")
    dev = xy.device
    if pw.device != dev or coef.device != dev:
        raise ValueError("xy, pw, coef must all be on one CPU or CUDA device")
    if dev.type == "cpu":
        return scatter_vote_reference(xy, pw, coef, width, height, plane_block)
    if dev.type != "cuda":
        raise ValueError(f"scatter_vote runs on a CPU or CUDA device, not {dev}")
    if xy.data_ptr() % 8 or pw.data_ptr() % 4 or coef.data_ptr() % 16:
        raise ValueError("xy, pw, coef must start on 8, 4 and 16 bytes (float2, "
                         "float, float4 loads)")
    if E == 0 or Z * height * width == 0:  # nothing to vote: nothing to launch
        return torch.zeros((Z, height, width), dtype=torch.float32, device=dev)
    params = vote_params(Z, height, width, K, E // K)
    g = grid_shape(params, K, Z, height, width)
    xr, yr, fb = plan(coef, params, width, height)
    binned, off = bin_events(xy, pw, E // K, params, width, height)
    # Plane-major: a warp's events come from the packets of a group, so one
    # plane's coefficients for them lie together.
    coef_zk = coef.transpose(0, 1).contiguous()
    dsi = torch.empty((Z, height, width), dtype=torch.float32, device=dev)
    counts = _counts(dev)
    _build.check(_library().scatter_tiles(
        binned.data_ptr(), off.data_ptr(), xr.data_ptr(), yr.data_ptr(), fb.data_ptr(),
        coef_zk.data_ptr(), dsi.data_ptr(), 0 if counts is None else counts.data_ptr(), K, Z,
        height, width, g["groups"], g["cells_x"], g["cells_y"], params.tile_w, params.tile_h,
        params.pitch, params.slab, torch.cuda.current_stream(dev).cuda_stream), "scatter_tiles")
    tracing.launched(scatter_vote)
    return dsi


scatter_vote.launches = 0
