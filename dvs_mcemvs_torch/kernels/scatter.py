"""The exact vote: the CUDA kernel (csrc/scatter.cu) and its plain PyTorch
version.

For every event e of packet k = e // P, with z0 location (x, y) and flat
weight w, and every plane z of a (K, Z) table of Eq. 15 coefficients
(a, bx, by, d) = coef[k, z]:

    X = (x * a + bx) / d,    Y = (y * a + by) / d

and, where 0 <= X < W - 1 and 0 <= Y < H - 1, the four bilinear taps of
(X, Y), each times w, are added into plane z of a (Z, H, W) float32 DSI.
Both versions round each operation once in float32, in this order, so a
tap's index and weight agree to the bit and only the order of the sums
differs.  Weights are finite.
"""

from __future__ import annotations

import ctypes

import torch

from .. import tracing
from . import _build

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int
# DSI bytes a slab of planes may cover, a quarter of the H100's 50 MB L2:
# the blocks in flight add into one slab at a time, which stays in L2
# (csrc/scatter.cu).
SLAB_BYTES = 12 << 20
# Threads a block (csrc/scatter.cu: kThreads); events a launch (a 32-bit
# index).
THREADS = 256
MAX_EVENTS = 2**31 - THREADS


def _library() -> ctypes.CDLL:
    lib = _build.load("scatter")
    if "scatter_vote" in vars(lib):  # argtypes already set on this library
        return lib
    lib.scatter_vote.argtypes = [_c_void_p] * 4 + [_c_int] * 6 + [_c_void_p]
    lib.scatter_vote.restype = _c_int
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


def slab_planes(Z: int, height: int, width: int) -> int:
    """Planes a slab of the kernel's grid (one grid row): as many as fit
    SLAB_BYTES (at least one), evened out over the slabs that Z needs."""
    per = max(1, SLAB_BYTES // (4 * height * width))
    slabs = -(-Z // per)
    return -(-Z // slabs)


def scatter_vote(xy: torch.Tensor, pw: torch.Tensor, coef: torch.Tensor, *,
                 width: int, height: int, plane_block: int = 8) -> torch.Tensor:
    """Vote E events into a fresh (Z, height, width) float32 DSI.

    xy: (E, 2) z0 locations; pw: (E,) flat weights (packet validity times
    the event's weight); coef: (K, Z, 4) Eq. 15 coefficients (a, bx, by, d)
    of each packet and plane, E = K * P; all float32 and contiguous.  A CPU
    tensor runs the plain version (`plane_block` planes at a time); a CUDA
    tensor launches the kernel once on the current stream, unless there is
    nothing to vote."""
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
    n = Z * height * width
    # Whole 16 bytes: a row's taps may go out as one float4 reduction.
    out = torch.zeros(-(-n // 4) * 4, dtype=torch.float32, device=dev)
    dsi = out[:n].view(Z, height, width)
    if E == 0 or n == 0:  # nothing to vote: nothing to launch
        return dsi
    slab = slab_planes(Z, height, width)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(_library().scatter_vote(
        xy.data_ptr(), pw.data_ptr(), coef.data_ptr(), out.data_ptr(), E, E // K, Z,
        height, width, slab, stream), "scatter_vote")
    tracing.launched(scatter_vote)
    return dsi


scatter_vote.launches = 0
