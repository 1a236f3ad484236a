"""Bilinear event binning: the CUDA kernel (csrc/binning.cu), its launch
plan and its plain PyTorch versions.

    hist[g, q, p] = sum_e w[g, e] * hat(q - hy[g, e]) * hat(p - hx[g, e])

with hat(d) = max(0, 1 - |d|), at the rounding points of the JAX package's
`bin_events_pallas_windowed` and `bin_events_pallas`: taps rounded to bf16
(the y tap after the weight multiply), f32 products and f32 accumulation; or,
in the int8 mode, integer taps rint(fl(hat_y * w) * 127) and
rint(hat_x * 127) summed exactly, scaled once by the f32 constant
1/(127*127).  One kernel serves both TPU kernels: a scatter needs no row sort,
so the dense form (any hs % 8 == 0) and the windowed form (hs % 64 == 0) are
the same function here.

The kernel sums each group's plane in shared memory: `plan` cuts the plane
into bands of rows, one thread-block cluster a band, R rows a block, and
the kernel writes every bin once.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from . import _build

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int
# 1/(127*127) rounded once to f32, as the TPU kernels' constant.
INT8_SCALE = float(np.float32(1.0) / np.float32(127.0 * 127.0))

# The kernel's shared memory (csrc/binning.cu): a block may use 232,448
# bytes on an H100; a ring of two chunks of 1024 staged events (hx, hy, w
# as f32) follows the accumulator's rows.
SMEM_LIMIT = 232_448
STAGE_BYTES = 2 * 3 * 1024 * 4
# Blocks a cluster (1-8, the portable sizes): the fastest at the headline
# grid on an H100 (scripts/tune_binning.py).
CLUSTER = 1
# An event adds at most 127 * 127 to an int8-mode bin, so unsigned 32-bit
# sums are exact up to this many events a group.
U32_MAX_EVENTS = (2**32 - 1) // (127 * 127)
# Blocks a launch may hold on grid x, where the groups lie (csrc/binning.cu).
MAX_GRID_X = 2**31 - 1
_ACC_BYTES = {"f32": 4, "u32": 4, "u64": 8}
_ACC_CODE = {"f32": 0, "u32": 1, "u64": 2}


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one kernel launch covers a (G, hs, ws) histogram: `bands` bands
    of rows a group, one cluster of `cluster` blocks a band, `rows` rows of
    `acc` sums a block in `smem_bytes` of shared memory."""

    hs: int
    ws: int
    acc: str
    rows: int
    cluster: int
    bands: int
    smem_bytes: int

    def band_rows(self) -> List[Tuple[int, int]]:
        """[lo, hi) of each band, in order."""
        span = self.cluster * self.rows
        return [(min(b * span, self.hs), min((b + 1) * span, self.hs))
                for b in range(self.bands)]

    def block_rows(self) -> List[Tuple[int, int]]:
        """[lo, hi) of each block's rows, band by band and rank by rank,
        as the kernel assigns them (a block past hs holds none)."""
        out = []
        for i in range(self.bands * self.cluster):
            lo = min(i * self.rows, self.hs)
            out.append((lo, min(lo + self.rows, self.hs)))
        return out


def max_rows(ws: int, acc: str, smem_limit: int = SMEM_LIMIT) -> int:
    """The most rows of `ws` `acc` sums a block holds beside its staged
    events."""
    return (smem_limit - STAGE_BYTES) // (ws * _ACC_BYTES[acc])


@functools.lru_cache(maxsize=None)
def plan(hs: int, ws: int, E: int, int8: bool, cluster: int = CLUSTER,
         smem_limit: int = SMEM_LIMIT) -> Plan:
    """The launch plan of `bin_events` for (G, E) events into (G, hs, ws).

    Sums: f32 for bf16 taps; for int8 taps u32 while E <= U32_MAX_EVENTS,
    else u64.  A band holds `cluster` blocks (fewer when hs has fewer rows)
    of the most rows that fit `smem_limit`; the bands are then evened out,
    so no band holds more rows than it needs.  Raises ValueError when one
    row of sums does not fit."""
    if hs < 1 or ws < 1 or E < 1:
        raise ValueError(f"plan needs hs, ws, E >= 1, got {hs}, {ws}, {E}")
    if not 1 <= cluster <= 8:
        raise ValueError(f"cluster must be 1-8 blocks, got {cluster}")
    acc = "f32" if not int8 else "u32" if E <= U32_MAX_EVENTS else "u64"
    cap = max_rows(ws, acc, smem_limit)
    if cap < 1:
        raise ValueError(
            f"a row of {ws} {acc} sums needs {ws * _ACC_BYTES[acc]} bytes of shared "
            f"memory; a block holds {smem_limit - STAGE_BYTES} beside its staged events, "
            f"so ws <= {(smem_limit - STAGE_BYTES) // _ACC_BYTES[acc]}")
    C = min(cluster, hs)
    bands = -(-hs // (C * cap))
    rows = -(-hs // (bands * C))
    smem = -(-rows * ws * _ACC_BYTES[acc] // 16) * 16 + STAGE_BYTES
    return Plan(hs=hs, ws=ws, acc=acc, rows=rows, cluster=C, bands=bands, smem_bytes=smem)


def _library() -> ctypes.CDLL:
    lib = _build.load("binning")
    if "bin_events" in vars(lib):  # argtypes already set on this library
        return lib
    lib.bin_events.argtypes = [_c_void_p] * 4 + [_c_int] * 9 + [_c_void_p]
    lib.bin_events.restype = _c_int
    lib.bin_events_int8.argtypes = [_c_void_p] * 4 + [_c_int] * 10 + [_c_void_p]
    lib.bin_events_int8.restype = _c_int
    lib.bin_events_max_active_clusters.argtypes = [_c_int] * 4 + [_c_void_p]
    lib.bin_events_max_active_clusters.restype = _c_int
    return lib


def _hat(d: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(d), min=0.0)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _scatter_taps(hx, hy, w, hs, ws, acc_dtype, y_tap, x_tap, rows=None) -> torch.Tensor:
    """`index_add_` of the four taps y_tap(hat_y, w) * x_tap(hat_x) of every
    live event into a flat (G * n_rows * ws) accumulator of `acc_dtype`,
    over the rows [lo, hi) = `rows` of the grid (all hs rows by default)."""
    G, E = hx.shape
    lo, hi = (0, hs) if rows is None else rows
    hist = torch.zeros(G * (hi - lo) * ws, dtype=acc_dtype, device=hx.device)
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
            ok = (q >= max(lo, 0)) & (q < min(hi, hs)) & (p >= 0) & (p < ws)
            idx = (g * (hi - lo) + q - lo) * ws + p
            hist.index_add_(0, idx[ok], (ay * ax)[ok])
    return hist


def bin_events_reference(hx: torch.Tensor, hy: torch.Tensor, w: torch.Tensor,
                         hs: int, ws: int, rows: Optional[Tuple[int, int]] = None
                         ) -> torch.Tensor:
    """Plain version: `index_add_` of the four bf16-rounded taps of every
    event into a (G, hs, ws) float32 histogram; with `rows` = (lo, hi) only
    those rows, (G, hi - lo, ws), as one band of the kernel holds them."""
    hist = _scatter_taps(hx, hy, w, hs, ws, torch.float32,
                         lambda hat_y, w_: _bf16(hat_y * w_), _bf16, rows)
    return hist.reshape(hx.shape[0], -1, ws)


def bin_events_int8_reference(hx: torch.Tensor, hy: torch.Tensor, w: torch.Tensor,
                              hs: int, ws: int, rows: Optional[Tuple[int, int]] = None
                              ) -> torch.Tensor:
    """Plain version of the int8 mode: integer taps (torch.round rounds half
    to even, as jnp.round) summed exactly in int64, then one f32 multiply by
    INT8_SCALE.  Returns (G, hs, ws) float32, or the rows `rows` of it."""
    def quantize(t):
        return torch.round(t * 127.0).to(torch.int64)

    hist = _scatter_taps(hx, hy, w, hs, ws, torch.int64,
                         lambda hat_y, w_: quantize(hat_y * w_), quantize, rows)
    return hist.to(torch.float32).mul_(INT8_SCALE).reshape(hx.shape[0], -1, ws)


_MAX_CLUSTERS: Dict[tuple, int] = {}


def max_active_clusters(p: Plan, bf16_out: bool) -> int:
    """cudaOccupancyMaxActiveClusters for `p`'s instantiation and shared
    memory: how many of its clusters the card holds at once (0: none fit).
    Needs the card."""
    key = (p.acc, bool(bf16_out), p.cluster, p.smem_bytes)
    if key not in _MAX_CLUSTERS:
        result = ctypes.c_int(0)
        _build.check(_library().bin_events_max_active_clusters(
            _ACC_CODE[p.acc], int(bf16_out), p.cluster, p.smem_bytes,
            ctypes.addressof(result)), "bin_events_max_active_clusters")
        _MAX_CLUSTERS[key] = result.value
    return _MAX_CLUSTERS[key]


def launch(hx: torch.Tensor, hy: torch.Tensor, w: torch.Tensor, p: Plan,
           out_dtype: torch.dtype) -> torch.Tensor:
    """One launch of the kernel under plan `p` on contiguous (G, E) CUDA
    events; returns the (G, p.hs, p.ws) histogram in `out_dtype`.  The
    int8 mode is `p.acc` u32 or u64."""
    G, E = hx.shape
    bf16_out = out_dtype == torch.bfloat16
    if G * p.cluster * p.bands > MAX_GRID_X:
        raise ValueError(f"{G} groups of {p.cluster * p.bands} blocks exceed the "
                         f"grid's {MAX_GRID_X} blocks")
    if max_active_clusters(p, bf16_out) < 1:
        raise RuntimeError(f"bin_events: no cluster of {p.cluster} blocks with "
                           f"{p.smem_bytes} bytes of shared memory fits on the card")
    out = torch.empty((G, p.hs, p.ws), dtype=out_dtype, device=hx.device)
    lib = _library()
    stream = torch.cuda.current_stream(hx.device).cuda_stream
    ptrs = (hx.data_ptr(), hy.data_ptr(), w.data_ptr(), out.data_ptr(), int(bf16_out))
    shape = (G, E, p.hs, p.ws, p.rows, p.cluster, p.bands, p.smem_bytes, stream)
    if p.acc == "f32":
        _build.check(lib.bin_events(*ptrs, *shape), "bin_events")
    else:
        _build.check(lib.bin_events_int8(*ptrs, int(p.acc == "u64"), *shape),
                     "bin_events_int8")
    bin_events.launches += 1
    return out


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
    wrap (inside `deferred_weight_checks`, both checks set a device flag
    instead).  A CPU tensor runs the plain version; a CUDA tensor launches
    the kernel once, under `plan`, and checks the weights while it runs.
    """
    if hx.ndim != 2 or hx.shape != hy.shape or hx.shape != w.shape:
        raise ValueError(f"hx, hy, w must share one (G, E) shape, got "
                         f"{tuple(hx.shape)}, {tuple(hy.shape)}, {tuple(w.shape)}")
    if any(a.dtype != torch.float32 for a in (hx, hy, w)):
        raise TypeError("hx, hy, w must be float32")
    if out_dtype not in (None, torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    out_t = out_dtype or torch.float32
    dev = hx.device
    if dev.type == "cpu":
        _check_weights(w, binary_w, int8)
        if int8:
            hist = bin_events_int8_reference(hx, hy, w, hs, ws)
        else:
            hist = bin_events_reference(hx, hy, w, hs, ws)
        return hist.to(out_t)
    if dev.type != "cuda" or hy.device != dev or w.device != dev:
        raise ValueError("hx, hy, w must all be on one CPU or CUDA device")
    if not (hx.is_contiguous() and hy.is_contiguous() and w.is_contiguous()):
        raise ValueError("hx, hy, w must be contiguous")
    G, E = hx.shape
    if G * E * hs * ws == 0:  # no events or no bins: nothing to launch
        _check_weights(w, binary_w, int8)
        return torch.zeros((G, hs, ws), dtype=out_t, device=dev)
    # The launch goes first: the weight check waits for the card, and the
    # host's launch work then overlaps the kernel instead of idling it.  A
    # histogram of refused weights is never returned.
    hist = launch(hx, hy, w, plan(hs, ws, E, int8), out_t)
    _check_weights(w, binary_w, int8)
    return hist


# The weight checks' messages, in the order of a fault flag's entries.
WEIGHT_FAULTS = ("binary_w=True but the weights are not all 0 or 1",
                 "int8=True needs weights in [0, 1]")
_deferred = threading.local()


def fault_flag(device) -> torch.Tensor:
    """A fresh fault flag for `deferred_weight_checks`: one int32 per entry
    of WEIGHT_FAULTS, zero."""
    return torch.zeros(len(WEIGHT_FAULTS), dtype=torch.int32, device=device)


@contextlib.contextmanager
def deferred_weight_checks(flag: torch.Tensor) -> Iterator[None]:
    """Inside (on this thread), `bin_events` does not read the device to
    check its weights: each check sets its entry of `flag` on the device
    instead, queued after the launch, so the calls can be captured in a CUDA
    graph.  `raise_weight_faults(flag)` raises what the checks found."""
    prev = getattr(_deferred, "flag", None)
    _deferred.flag = flag
    try:
        yield
    finally:
        _deferred.flag = prev


def raise_weight_faults(flag: torch.Tensor) -> None:
    """Read `flag` (one copy to the host) and raise the ValueError of its
    first set entry, clearing the flag; return when none is set."""
    found = flag.tolist()
    for message, bad in zip(WEIGHT_FAULTS, found):
        if bad:
            flag.zero_()
            raise ValueError(message)


def _check_weights(w: torch.Tensor, binary_w: bool, int8: bool) -> None:
    """Raise on weights the mode does not take (see bin_events), or, inside
    `deferred_weight_checks`, set the flag's entries on the device."""
    flag = getattr(_deferred, "flag", None)
    if flag is not None:
        if binary_w:
            flag[0] |= (~((w == 0) | (w == 1))).any()
        if int8:
            # (a NaN fails both comparisons)
            flag[1] |= (~((w >= 0) & (w <= 1))).any()
        return
    if binary_w and not bool(((w == 0) | (w == 1)).all()):
        raise ValueError(WEIGHT_FAULTS[0])
    if int8 and w.numel():
        # One reduction and one copy to the host (a NaN fails both tests).
        lo, hi = torch.stack(torch.aminmax(w)).tolist()
        if not (lo >= 0 and hi <= 1):
            raise ValueError(WEIGHT_FAULTS[1])


bin_events.launches = 0
