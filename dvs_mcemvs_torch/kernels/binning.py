"""Bilinear event binning: the CUDA kernel (csrc/binning.cu) and its plain
PyTorch versions.

    hist[g, q, p] = sum_e w[g, e] * hat(q - hy[g, e]) * hat(p - hx[g, e])

with hat(d) = max(0, 1 - |d|), at the rounding points of the JAX package's
`bin_events_pallas_windowed` and `bin_events_pallas`: taps rounded to bf16
(the y tap after the weight multiply), f32 products and f32 accumulation; or,
in the int8 mode, integer taps rint(fl(hat_y * w) * 127) and
rint(hat_x * 127) summed exactly, scaled once by the f32 constant
1/(127*127).  One kernel serves both TPU kernels: a scatter needs no row sort,
so the dense form (any hs % 8 == 0) and the windowed form (hs % 64 == 0) are
the same function here.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import _build

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int
# 1/(127*127) rounded once to f32, as the TPU kernels' constant.
INT8_SCALE = float(np.float32(1.0) / np.float32(127.0 * 127.0))


def _library() -> ctypes.CDLL:
    lib = _build.load("binning")
    lib.bin_events.argtypes = [_c_void_p] * 5 + [_c_int] * 4 + [_c_void_p]
    lib.bin_events.restype = _c_int
    lib.bin_events_int8.argtypes = [_c_void_p] * 5 + [_c_int] * 5 + [_c_void_p]
    lib.bin_events_int8.restype = _c_int
    return lib


def _hat(d: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(d), min=0.0)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _scatter_taps(hx, hy, w, hs, ws, acc_dtype, y_tap, x_tap) -> torch.Tensor:
    """`index_add_` of the four taps y_tap(hat_y, w) * x_tap(hat_x) of every
    live event into a flat (G * hs * ws) accumulator of `acc_dtype`."""
    G, E = hx.shape
    hist = torch.zeros(G * hs * ws, dtype=acc_dtype, device=hx.device)
    live = w != 0
    hx, hy, w = hx[live], hy[live], w[live]
    g = torch.arange(G, device=hx.device).repeat_interleave(E)[live.reshape(-1)]
    x0 = torch.floor(hx).to(torch.int64)
    y0 = torch.floor(hy).to(torch.int64)
    for dy in (0, 1):
        q = y0 + dy
        ay = y_tap(_hat(hy - q.to(torch.float32)), w)
        for dx in (0, 1):
            p = x0 + dx
            ax = x_tap(_hat(hx - p.to(torch.float32)))
            ok = (q >= 0) & (q < hs) & (p >= 0) & (p < ws)
            idx = (g * hs + q) * ws + p
            hist.index_add_(0, idx[ok], (ay * ax)[ok])
    return hist


def bin_events_reference(hx: torch.Tensor, hy: torch.Tensor, w: torch.Tensor,
                         hs: int, ws: int) -> torch.Tensor:
    """Plain version: `index_add_` of the four bf16-rounded taps of every
    event into a (G, hs, ws) float32 histogram."""
    hist = _scatter_taps(hx, hy, w, hs, ws, torch.float32,
                         lambda hat_y, w_: _bf16(hat_y * w_), _bf16)
    return hist.reshape(hx.shape[0], hs, ws)


def bin_events_int8_reference(hx: torch.Tensor, hy: torch.Tensor, w: torch.Tensor,
                              hs: int, ws: int) -> torch.Tensor:
    """Plain version of the int8 mode: integer taps (torch.round rounds half
    to even, as jnp.round) summed exactly in int64, then one f32 multiply by
    INT8_SCALE.  Returns (G, hs, ws) float32."""
    def quantize(t):
        return torch.round(t * 127.0).to(torch.int64)

    hist = _scatter_taps(hx, hy, w, hs, ws, torch.int64,
                         lambda hat_y, w_: quantize(hat_y * w_), quantize)
    return hist.to(torch.float32).mul_(INT8_SCALE).reshape(hx.shape[0], hs, ws)


def bin_events(hx: torch.Tensor, hy: torch.Tensor, w: torch.Tensor, *,
               hs: int, ws: int, binary_w: bool = False, int8: bool = False,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Bin (G, E) events into (G, hs, ws) histograms, float32 or `out_dtype`
    (bfloat16).  Taps are bf16 with float32 accumulation, or with `int8`
    quantized to 1/127 steps and summed exactly; either way the result is
    cast once to `out_dtype`.

    hx, hy, w: (G, E) float32, coordinates already clipped to [0, ws-1] /
    [0, hs-1] and out-of-grid events zero-weighted (the caller,
    `voting_hist.build_group_histograms`, does both).  Any hs: this covers
    the TPU's dense kernel (hs % 8 == 0) and its row-windowed one
    (hs % 64 == 0).  Zero-weight events contribute nothing.
    `binary_w=True` asserts the weights are 0/1 and raises otherwise; `int8`
    raises on weights outside [0, 1], where the TPU kernels' int8 taps would
    wrap.  A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel.
    """
    if hx.ndim != 2 or hx.shape != hy.shape or hx.shape != w.shape:
        raise ValueError(f"hx, hy, w must share one (G, E) shape, got "
                         f"{tuple(hx.shape)}, {tuple(hy.shape)}, {tuple(w.shape)}")
    if any(a.dtype != torch.float32 for a in (hx, hy, w)):
        raise TypeError("hx, hy, w must be float32")
    if out_dtype not in (None, torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if binary_w and not bool(((w == 0) | (w == 1)).all()):
        raise ValueError("binary_w=True but the weights are not all 0 or 1")
    if int8 and not bool(((w >= 0) & (w <= 1)).all()):
        raise ValueError("int8=True needs weights in [0, 1]")
    bf16_out = out_dtype == torch.bfloat16
    dev = hx.device
    if dev.type == "cpu":
        if int8:
            hist = bin_events_int8_reference(hx, hy, w, hs, ws)
        else:
            hist = bin_events_reference(hx, hy, w, hs, ws)
        return hist.to(torch.bfloat16) if bf16_out else hist
    if dev.type != "cuda" or hy.device != dev or w.device != dev:
        raise ValueError("hx, hy, w must all be on one CPU or CUDA device")
    if not (hx.is_contiguous() and hy.is_contiguous() and w.is_contiguous()):
        raise ValueError("hx, hy, w must be contiguous")
    G, E = hx.shape
    out_t = torch.bfloat16 if bf16_out else torch.float32
    if G * E == 0:  # no events: nothing to launch
        return torch.zeros((G, hs, ws), dtype=out_t, device=dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if int8:
        acc = torch.zeros((G, hs, ws), dtype=torch.int64, device=dev)
        out = torch.empty((G, hs, ws), dtype=out_t, device=dev)
        _build.check(lib.bin_events_int8(
            hx.data_ptr(), hy.data_ptr(), w.data_ptr(), acc.data_ptr(), out.data_ptr(),
            int(bf16_out), G, E, hs, ws, stream), "bin_events_int8")
    else:
        hist = torch.zeros((G, hs, ws), dtype=torch.float32, device=dev)
        out = torch.empty((G, hs, ws), dtype=out_t, device=dev) if bf16_out else hist
        _build.check(lib.bin_events(
            hx.data_ptr(), hy.data_ptr(), w.data_ptr(), hist.data_ptr(),
            out.data_ptr() if bf16_out else None, G, E, hs, ws, stream), "bin_events")
    bin_events.launches += 1
    return out


bin_events.launches = 0
