"""Banded separable affine resample-and-accumulate: the CUDA kernel
(csrc/resample.cu) behind both resample wrappers, and its plain PyTorch
version.

Item j of a call produces output plane out_idx[j]:

    out[o_j, v, u] = sum_k sum_p hat(p*sx + tx - u) *
                     acc( sum_q hat(q*sy + ty - v) * src[src_idx[j, k], q, p] )

with (sy, ty, sx, tx) = maps[j, k] in bin coordinates (forward convention:
output position = input position * s + t) and hat(d) = max(0, 1 - |d|).
For bf16 sources the taps are rounded to bf16 and acc() rounds the y-stage
sum to bf16 (the JAX kernels' `resy` scratch); f32 sources keep f32 taps and
no rounding.  Sums are float32, with one cast to `out_dtype`.

`banded_resample_sum` (the butterfly merge levels) and
`banded_resample_fanin` (the plane sweep and the radix-8 merge levels) keep
the JAX package's signatures and only translate their indexing into items.
The items of a call are `Items`: device int32 tables built once per key and
device by `cached_items` (checked when built, never when used), so a call
copies nothing from the host and reads nothing back, and can be captured in
a CUDA graph.  The wrappers also take host index arrays (numpy or CPU
tensors), which they route through the same cache by their contents.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
from typing import Callable, Iterator, List, Optional

import numpy as np
import torch

from . import _build

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int
# Items a call (grid x of csrc/resample.cu) times sources an item: the
# kernel's 32-bit index into the maps.
_MAX_ITEM_SOURCES = 2**31 - 1
_REFERENCE_BYTES = 2**28  # working-set bound of one batch of the plain version
# Item tables kept: a process_1 chunk fetches 4-6 keys a camera and a run
# sees a few chunk shapes, so this bounds only callers that pass many
# distinct host arrays; each table is a few KB.  A captured program keeps
# the tables its graph reads (`tables_in_use`), evicted or not.
TABLE_CACHE_SIZE = 256


def _library() -> ctypes.CDLL:
    lib = _build.load("resample")
    if "banded_resample" in vars(lib):  # argtypes already set on this library
        return lib
    lib.banded_resample.argtypes = ([_c_void_p, _c_int] + [_c_void_p] * 7
                                    + [_c_int] * 7 + [_c_void_p])
    lib.banded_resample.restype = _c_int
    return lib


def _hat(d: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(d), min=0.0)


def banded_resample_reference(src: torch.Tensor, src_idx: torch.Tensor,
                              sy: torch.Tensor, ty: torch.Tensor,
                              sx: torch.Tensor, tx: torch.Tensor,
                              out_idx: torch.Tensor, *, n_out: int, out_h: int,
                              out_w: int,
                              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version: per item, dense hat matrices Ry (hs, out_h) and
    Cx (ws, out_w), out = sum_k acc(Ry^T @ src) @ Cx in float32 matmuls at
    the kernel's rounding points.  src_idx/maps (J, K), out_idx (J,)
    distinct; planes no item writes are zero."""
    dev = src.device
    hs, ws = src.shape[1:]
    J, K = src_idx.shape
    if src.dtype == torch.bfloat16:
        def rnd(x):
            return x.to(torch.bfloat16).to(torch.float32)
    else:
        def rnd(x):
            return x
    q = torch.arange(hs, dtype=torch.float32, device=dev)[None, :, None]
    p = torch.arange(ws, dtype=torch.float32, device=dev)[None, :, None]
    v = torch.arange(out_h, dtype=torch.float32, device=dev)[None, None, :]
    u = torch.arange(out_w, dtype=torch.float32, device=dev)[None, None, :]
    out = torch.zeros((n_out, out_h, out_w), dtype=torch.float32, device=dev)
    per_item = 4 * (hs * out_h + ws * out_w + 2 * hs * ws + out_h * ws + out_h * out_w)
    chunk = max(1, _REFERENCE_BYTES // per_item)
    for j0 in range(0, J, chunk):
        jj = slice(j0, min(j0 + chunk, J))
        acc = torch.zeros((jj.stop - j0, out_h, out_w), dtype=torch.float32, device=dev)
        for k in range(K):
            ry = rnd(_hat(q * sy[jj, k, None, None] + ty[jj, k, None, None] - v))
            cx = rnd(_hat(p * sx[jj, k, None, None] + tx[jj, k, None, None] - u))
            h = src[src_idx[jj, k]].to(torch.float32)
            resy = rnd(torch.matmul(ry.transpose(1, 2), h))     # (nj, out_h, ws)
            acc += torch.matmul(resy, cx)
        out[out_idx[jj]] = acc
    return out if out_dtype in (None, torch.float32) else out.to(out_dtype)


def host_index(a) -> torch.Tensor:
    """A host index array as a C-contiguous int32 CPU tensor, the layout the
    kernel reads.  (`np.array` keeps the layout of its input, so a broadcast
    (N, K) array would come back in column order.)"""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


@dataclasses.dataclass(frozen=True, eq=False)
class Items:
    """The items of a call as device tables: item j reads sources
    `src_idx[j]` and writes plane `out_idx[j]` of `n_out`; a fan-in call
    also takes item j's maps from row `sel[j]` of its (Ngrp*M, K) maps."""

    src_idx: torch.Tensor            # (J, K) int32, row-major
    out_idx: torch.Tensor            # (J,) int32, distinct
    sel: Optional[torch.Tensor]      # (J,) int64, fan-in calls only
    n_src: int                       # sources the items read: max(src_idx) + 1
    n_out: int
    covered: bool                    # every output plane has an item


_TABLES: "collections.OrderedDict[tuple, object]" = collections.OrderedDict()
_IN_USE: List[list] = []


@contextlib.contextmanager
def tables_in_use() -> Iterator[list]:
    """Collect every table fetched inside into the yielded list, so that a
    CUDA graph captured inside can hold the tables it reads."""
    used: list = []
    _IN_USE.append(used)
    try:
        yield used
    finally:
        _IN_USE.remove(used)


def _cached(key: tuple, device, make: Callable[[], object]):
    """The table of (key, device), made once by `make()`; least recently
    used tables beyond TABLE_CACHE_SIZE are dropped."""
    full = (key, torch.device(device))
    table = _TABLES.get(full)
    if table is None:
        table = _TABLES[full] = make()
        while len(_TABLES) > TABLE_CACHE_SIZE:
            _TABLES.popitem(last=False)
    else:
        _TABLES.move_to_end(full)
    for used in _IN_USE:
        used.append(table)
    return table


def cached_index(key: tuple, device, build: Callable[[], np.ndarray]) -> torch.Tensor:
    """A host index array `build()` as an int64 tensor on `device`, made
    once per key (a gather index beside a call's items)."""
    return _cached(key, device, lambda: torch.tensor(np.asarray(build(), np.int64),
                                                     device=device))


def cached_items(key: tuple, device, build: Callable[[], tuple]) -> Items:
    """The `Items` of `key` on `device`, built once from `build()` =
    (src_idx (J, K), out_idx (J,), sel (J,) or None, n_out) host arrays.
    Indices are checked here: out_idx distinct and in [0, n_out), src_idx
    and sel >= 0."""
    def make():
        src_idx, out_idx, sel, n_out = build()
        src_idx, out_idx = np.asarray(src_idx), np.asarray(out_idx).reshape(-1)
        J = out_idx.shape[0]
        if src_idx.ndim != 2 or src_idx.shape[0] != J:
            raise ValueError(f"src_idx {src_idx.shape} does not give sources for {J} items")
        if J and (src_idx.min() < 0 or (sel is not None and np.min(sel) < 0)):
            raise ValueError("source index out of range")
        if J and (out_idx.min() < 0 or out_idx.max() >= n_out):
            raise ValueError("output index out of range")
        distinct = len(np.unique(out_idx))
        if distinct != J:
            raise ValueError("an output plane has more than one item")
        # Copies, also on the CPU: a caller's array may change after this.
        return Items(
            src_idx=host_index(src_idx).to(device, copy=True),
            out_idx=host_index(out_idx).to(device, copy=True),
            sel=None if sel is None else torch.tensor(np.asarray(sel, np.int64), device=device),
            n_src=int(src_idx.max()) + 1 if src_idx.size else 0, n_out=int(n_out),
            covered=distinct == n_out)

    return _cached(key, device, make)


def _host_key(a) -> tuple:
    """A host index array's key: its shape and contents."""
    a = np.ascontiguousarray(a, dtype=np.int32)
    return a.shape, a.tobytes()


def sum_tables(src) -> tuple:
    """`cached_items`' build of a sum call: item n reads `src[n]`, writes n."""
    src = np.asarray(src)
    return src, np.arange(src.shape[0]), None, src.shape[0]


def fanin_tables(out_idx, K: int, n_out: int) -> tuple:
    """`cached_items`' build of a fan-in call over (Ngrp, M) `out_idx`: one
    item per output plane, its last writer in (g, m) order (the order the
    sequential TPU grid writes in), so that parallel blocks never race on
    duplicate entries; the item reads its group's K blocks."""
    out_idx = np.asarray(out_idx)
    M = out_idx.shape[1]
    flat = out_idx.reshape(-1)
    _, first_rev = np.unique(flat[::-1], return_index=True)
    pos = flat.size - 1 - first_rev
    src_idx = (pos // M)[:, None] * K + np.arange(K)[None, :]
    return src_idx, flat[pos], pos, n_out


def _run(src, items: Items, sy, ty, sx, tx, *, out_h, out_w, out_dtype,
         counter) -> torch.Tensor:
    """Run `items` over `src`: the plain version for a CPU source, the
    kernel for a CUDA source.  Nothing here reads the device.  `counter` (a
    public wrapper) gains one launch when the kernel is launched; a call
    with no items or an empty output plane launches nothing."""
    if src.ndim != 3 or src.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sources must be (n, hs, ws) float32/bfloat16, got "
                        f"{tuple(src.shape)} {src.dtype}")
    if not src.is_contiguous():
        raise ValueError("sources must be contiguous")
    if out_dtype not in (None, torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    dev = src.device
    J, K = items.src_idx.shape
    for name, m in (("sy", sy), ("ty", ty), ("sx", sx), ("tx", tx)):
        if m.shape != (J, K) or m.dtype != torch.float32 or m.device != dev:
            raise ValueError(f"{name} must be ({J}, {K}) float32 on {dev}, "
                             f"got {tuple(m.shape)} {m.dtype} on {m.device}")
    if items.src_idx.device != dev:
        raise ValueError(f"index tables on {items.src_idx.device}, sources on {dev}")
    if items.n_src > src.shape[0]:
        raise ValueError("source index out of range")
    n_out = items.n_out
    if dev.type == "cpu":
        return banded_resample_reference(
            src, items.src_idx.long(), sy, ty, sx, tx, items.out_idx.long(), n_out=n_out,
            out_h=out_h, out_w=out_w, out_dtype=out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if J * K > _MAX_ITEM_SOURCES:
        raise ValueError(f"{J} items of {K} sources exceed the kernel's "
                         f"{_MAX_ITEM_SOURCES}")
    bf16_out = out_dtype == torch.bfloat16
    dtype = torch.bfloat16 if bf16_out else torch.float32
    alloc = torch.empty if items.covered else torch.zeros
    out = alloc((n_out, out_h, out_w), dtype=dtype, device=dev)
    if J == 0 or out_h * out_w == 0:
        return out
    maps = [m.contiguous() for m in (sy, ty, sx, tx)]
    hs, ws = src.shape[1:]
    _build.check(_library().banded_resample(
        src.data_ptr(), int(src.dtype == torch.bfloat16), items.src_idx.data_ptr(),
        *(m.data_ptr() for m in maps), items.out_idx.data_ptr(), out.data_ptr(),
        int(bf16_out), J, K, hs, ws, out_h, out_w,
        torch.cuda.current_stream(dev).cuda_stream), "banded_resample")
    counter.launches += 1
    return out


def banded_resample_sum(hist: torch.Tensor, sy: torch.Tensor, ty: torch.Tensor,
                        sx: torch.Tensor, tx: torch.Tensor, *, out_h: int,
                        out_w: int, blocked: bool, src=None,
                        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """out[n] = sum_k resample(hist[src(n, k)], maps (sy..tx)[n, k]).

    hist: (G, hs, ws); maps (N, K) float32.  blocked=False: src = k (the
    plane sweep, G == K); blocked=True: src = n*K + k (disjoint groups,
    G == N*K); an explicit `src` overrides both: a host (N, K) array or the
    `Items` of a sum call (`cached_items` over `sum_tables`).  Returns
    (N, out_h, out_w) in `out_dtype` (float32 by default).
    """
    G = hist.shape[0]
    N, K = sy.shape
    dev = hist.device
    if isinstance(src, Items):
        items = src
    elif src is None:
        if blocked and G != N * K:
            raise ValueError(f"blocked mode needs G == N*K, got {G} != {N}*{K}")
        if not blocked and G != K:
            raise ValueError(f"sweep mode needs G == K, got {G} != {K}")

        def build():
            base = np.arange(K)[None, :] + (np.arange(N)[:, None] * K if blocked else 0)
            return sum_tables(np.broadcast_to(base, (N, K)))

        items = cached_items(("sum", N, K, blocked), dev, build)
    else:
        src = np.asarray(src)
        if src.shape != (N, K):
            raise ValueError(f"src shape {src.shape} != maps shape {(N, K)}")
        items = cached_items(("sum-src",) + _host_key(src), dev, lambda: sum_tables(src))
    if items.src_idx.shape != (N, K):
        raise ValueError(f"src shape {tuple(items.src_idx.shape)} != maps shape {(N, K)}")
    return _run(hist, items, sy, ty, sx, tx, out_h=out_h, out_w=out_w,
                out_dtype=out_dtype, counter=banded_resample_sum)


def _fanin(blocks: torch.Tensor, sy: torch.Tensor, ty: torch.Tensor,
           sx: torch.Tensor, tx: torch.Tensor, out_idx, n_out: int):
    """A fan-in call as (sources (Ngrp*K, hs, ws), Items, [sy, ty, sx, tx]
    each (J, K))."""
    Ngrp, K, hs, ws = blocks.shape
    M = sy.shape[1]
    if sy.shape != (Ngrp, M, K):
        raise ValueError(f"maps shape {tuple(sy.shape)} != {(Ngrp, M, K)}")
    if isinstance(out_idx, Items):
        items = out_idx
    else:
        flat = np.asarray(out_idx)
        if flat.size != Ngrp * M:
            raise ValueError(f"out_idx must hold {Ngrp}x{M} indices, got {flat.shape}")
        flat = flat.reshape(Ngrp, M)
        items = cached_items(("fanin", K, n_out) + _host_key(flat), blocks.device,
                             lambda: fanin_tables(flat, K, n_out))
    if items.sel is None or items.n_out != n_out:
        raise ValueError("out_idx must be a fan-in table of n_out planes")
    maps = [m.reshape(Ngrp * M, K).index_select(0, items.sel) for m in (sy, ty, sx, tx)]
    return blocks.reshape(Ngrp * K, hs, ws), items, maps


def fanin_items(blocks: torch.Tensor, sy: torch.Tensor, ty: torch.Tensor,
                sx: torch.Tensor, tx: torch.Tensor, out_idx, n_out: int):
    """A fan-in call into `n_out` planes as items, one per output plane
    (`fanin_tables`).

    Returns (sources (Ngrp*K, hs, ws), src_idx (J, K), [sy, ty, sx, tx]
    each (J, K), out_idx (J,)), the index tables int32 on the blocks'
    device."""
    sources, items, maps = _fanin(blocks, sy, ty, sx, tx, out_idx, n_out)
    return sources, items.src_idx, maps, items.out_idx


def banded_resample_fanin(blocks: torch.Tensor, sy: torch.Tensor,
                          ty: torch.Tensor, sx: torch.Tensor, tx: torch.Tensor,
                          out_idx, *, n_out: int, out_h: int, out_w: int,
                          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """out[out_idx[g, m]] = sum_k resample(blocks[g, k], maps (sy..tx)[g, m, k]).

    blocks: (Ngrp, K, hs, ws); maps (Ngrp, M, K) float32; out_idx: a host
    (Ngrp, M) integer array, or the `Items` of a fan-in call (`cached_items`
    over `fanin_tables`).  Ragged callers pad `out_idx` with duplicate
    indices; each output plane is computed once (`fanin_tables`).  Returns
    (n_out, out_h, out_w) in `out_dtype`.
    """
    sources, items, maps = _fanin(blocks, sy, ty, sx, tx, out_idx, n_out)
    return _run(sources, items, *maps, out_h=out_h, out_w=out_w, out_dtype=out_dtype,
                counter=banded_resample_fanin)


banded_resample_sum.launches = 0
banded_resample_fanin.launches = 0
