"""Bilinear event binning: the CUDA kernel (csrc/binning.cu) and its plain
PyTorch version.

    hist[g, q, p] = sum_e w[g, e] * hat(q - hy[g, e]) * hat(p - hx[g, e])

with hat(d) = max(0, 1 - |d|), taps rounded to bf16 (the y tap after the
weight multiply), f32 products and f32 accumulation -- the rounding points of
the JAX package's `bin_events_pallas_windowed`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int


def _library() -> ctypes.CDLL:
    lib = _build.load("binning")
    lib.bin_events.argtypes = [_c_void_p] * 5 + [_c_int] * 4 + [_c_void_p]
    lib.bin_events.restype = _c_int
    return lib


def _hat(d: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(d), min=0.0)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def bin_events_reference(hx: torch.Tensor, hy: torch.Tensor, w: torch.Tensor,
                         hs: int, ws: int) -> torch.Tensor:
    """Plain version: `index_add_` of the four bf16-rounded taps of every
    event into a (G, hs, ws) float32 histogram."""
    G, E = hx.shape
    hist = torch.zeros(G * hs * ws, dtype=torch.float32, device=hx.device)
    live = w != 0
    hx, hy, w = hx[live], hy[live], w[live]
    g = torch.arange(G, device=hx.device).repeat_interleave(E)[live.reshape(-1)]
    x0 = torch.floor(hx).to(torch.int64)
    y0 = torch.floor(hy).to(torch.int64)
    for dy in (0, 1):
        q = y0 + dy
        ay = _bf16(_hat(hy - q.to(torch.float32)) * w)
        for dx in (0, 1):
            p = x0 + dx
            ax = _bf16(_hat(hx - p.to(torch.float32)))
            ok = (q >= 0) & (q < hs) & (p >= 0) & (p < ws)
            idx = (g * hs + q) * ws + p
            hist.index_add_(0, idx[ok], (ay * ax)[ok])
    return hist.reshape(G, hs, ws)


def bin_events(hx: torch.Tensor, hy: torch.Tensor, w: torch.Tensor, *,
               hs: int, ws: int, binary_w: bool = False,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Bin (G, E) events into (G, hs, ws) histograms, float32 or `out_dtype`
    (bfloat16), accumulated in float32 either way.

    hx, hy, w: (G, E) float32, coordinates already clipped to [0, ws-1] /
    [0, hs-1] and out-of-grid events zero-weighted (the caller,
    `voting_hist.build_group_histograms`, does both).  Zero-weight events
    contribute nothing.  `binary_w=True` asserts the weights are 0/1 and
    raises otherwise.  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel.
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
    bf16_out = out_dtype == torch.bfloat16
    dev = hx.device
    if dev.type == "cpu":
        hist = bin_events_reference(hx, hy, w, hs, ws)
        return hist.to(torch.bfloat16) if bf16_out else hist
    if dev.type != "cuda" or hy.device != dev or w.device != dev:
        raise ValueError("hx, hy, w must all be on one CPU or CUDA device")
    if not (hx.is_contiguous() and hy.is_contiguous() and w.is_contiguous()):
        raise ValueError("hx, hy, w must be contiguous")
    G, E = hx.shape
    hist = torch.zeros((G, hs, ws), dtype=torch.float32, device=dev)
    if G * E == 0:  # no events: nothing to launch
        return hist.to(torch.bfloat16) if bf16_out else hist
    lib = _library()
    out = torch.empty((G, hs, ws), dtype=torch.bfloat16, device=dev) if bf16_out else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.bin_events(
        hx.data_ptr(), hy.data_ptr(), w.data_ptr(), hist.data_ptr(),
        out.data_ptr() if bf16_out else None, G, E, hs, ws, stream), "bin_events")
    bin_events.launches += 1
    return out if bf16_out else hist


bin_events.launches = 0
