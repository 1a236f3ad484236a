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
Index arrays (`src`, `out_idx`) are host arrays: numpy or CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import _build

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int
# Items a call (grid x of csrc/resample.cu) times sources an item: the
# kernel's 32-bit index into the maps.
_MAX_ITEM_SOURCES = 2**31 - 1
_REFERENCE_BYTES = 2**28  # working-set bound of one batch of the plain version


def _library() -> ctypes.CDLL:
    lib = _build.load("resample")
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


def _run(src, src_idx, sy, ty, sx, tx, out_idx, *, n_out, out_h, out_w,
         out_dtype, counter) -> torch.Tensor:
    """Check the items and run them: the plain version for a CPU source,
    the kernel for a CUDA source.  `counter` (a public wrapper) gains one
    launch when the kernel is launched; a call with no items or an empty
    output plane launches nothing."""
    if src.ndim != 3 or src.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sources must be (n, hs, ws) float32/bfloat16, got "
                        f"{tuple(src.shape)} {src.dtype}")
    if not src.is_contiguous():
        raise ValueError("sources must be contiguous")
    if out_dtype not in (None, torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    J, K = src_idx.shape
    for name, m in (("sy", sy), ("ty", ty), ("sx", sx), ("tx", tx)):
        if m.shape != (J, K) or m.dtype != torch.float32 or m.device != src.device:
            raise ValueError(f"{name} must be ({J}, {K}) float32 on {src.device}, "
                             f"got {tuple(m.shape)} {m.dtype} on {m.device}")
    if J and (src_idx.min() < 0 or src_idx.max() >= src.shape[0]):
        raise ValueError("source index out of range")
    if J and (out_idx.min() < 0 or out_idx.max() >= n_out):
        raise ValueError("output index out of range")
    dev = src.device
    src_idx_t = host_index(src_idx).to(dev)
    out_idx_t = host_index(out_idx).to(dev)
    if dev.type == "cpu":
        return banded_resample_reference(
            src, src_idx_t.long(), sy, ty, sx, tx, out_idx_t.long(), n_out=n_out,
            out_h=out_h, out_w=out_w, out_dtype=out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if J * K > _MAX_ITEM_SOURCES:
        raise ValueError(f"{J} items of {K} sources exceed the kernel's "
                         f"{_MAX_ITEM_SOURCES}")
    bf16_out = out_dtype == torch.bfloat16
    dtype = torch.bfloat16 if bf16_out else torch.float32
    covered = len(np.unique(out_idx)) == n_out
    alloc = torch.empty if covered else torch.zeros
    out = alloc((n_out, out_h, out_w), dtype=dtype, device=dev)
    if J == 0 or out_h * out_w == 0:
        return out
    maps = [m.contiguous() for m in (sy, ty, sx, tx)]
    hs, ws = src.shape[1:]
    _build.check(_library().banded_resample(
        src.data_ptr(), int(src.dtype == torch.bfloat16), src_idx_t.data_ptr(),
        *(m.data_ptr() for m in maps), out_idx_t.data_ptr(), out.data_ptr(),
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
    G == N*K); an explicit host (N, K) `src` overrides both.  Returns
    (N, out_h, out_w) in `out_dtype` (float32 by default).
    """
    G = hist.shape[0]
    N, K = sy.shape
    if src is None:
        if blocked and G != N * K:
            raise ValueError(f"blocked mode needs G == N*K, got {G} != {N}*{K}")
        if not blocked and G != K:
            raise ValueError(f"sweep mode needs G == K, got {G} != {K}")
        src = np.arange(K)[None, :] + (np.arange(N)[:, None] * K if blocked else 0)
        src = np.broadcast_to(src, (N, K))
    src = np.asarray(src)
    if src.shape != (N, K):
        raise ValueError(f"src shape {src.shape} != maps shape {(N, K)}")
    return _run(hist, src, sy, ty, sx, tx, np.arange(N), n_out=N, out_h=out_h,
                out_w=out_w, out_dtype=out_dtype, counter=banded_resample_sum)


def fanin_items(blocks: torch.Tensor, sy: torch.Tensor, ty: torch.Tensor,
                sx: torch.Tensor, tx: torch.Tensor, out_idx):
    """A fan-in call as items, one per output plane: the plane's last writer
    in (g, m) order (the order the sequential TPU grid writes in), so that
    parallel blocks never race on duplicate `out_idx` entries.

    Returns (sources (Ngrp*K, hs, ws), src_idx (J, K) host array,
    [sy, ty, sx, tx] each (J, K), out_idx (J,) host array)."""
    Ngrp, K, hs, ws = blocks.shape
    M = sy.shape[1]
    if sy.shape != (Ngrp, M, K):
        raise ValueError(f"maps shape {tuple(sy.shape)} != {(Ngrp, M, K)}")
    flat = np.asarray(out_idx).reshape(-1)
    if flat.shape != (Ngrp * M,):
        raise ValueError(f"out_idx must hold {Ngrp}x{M} indices, got {flat.shape}")
    _, first_rev = np.unique(flat[::-1], return_index=True)
    pos = flat.size - 1 - first_rev
    src_idx = (pos // M)[:, None] * K + np.arange(K)[None, :]
    sel = torch.as_tensor(pos, device=blocks.device)
    maps = [m.reshape(Ngrp * M, K)[sel] for m in (sy, ty, sx, tx)]
    return blocks.reshape(Ngrp * K, hs, ws), src_idx, maps, flat[pos]


def banded_resample_fanin(blocks: torch.Tensor, sy: torch.Tensor,
                          ty: torch.Tensor, sx: torch.Tensor, tx: torch.Tensor,
                          out_idx, *, n_out: int, out_h: int, out_w: int,
                          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """out[out_idx[g, m]] = sum_k resample(blocks[g, k], maps (sy..tx)[g, m, k]).

    blocks: (Ngrp, K, hs, ws); maps (Ngrp, M, K) float32; out_idx: host
    (Ngrp, M) integer array.  Ragged callers pad `out_idx` with duplicate
    indices; each output plane is computed once (`fanin_items`).  Returns
    (n_out, out_h, out_w) in `out_dtype`.
    """
    sources, src_idx, maps, items_out = fanin_items(blocks, sy, ty, sx, tx, out_idx)
    return _run(sources, src_idx, *maps, items_out, n_out=n_out, out_h=out_h,
                out_w=out_w, out_dtype=out_dtype, counter=banded_resample_fanin)


banded_resample_sum.launches = 0
banded_resample_fanin.launches = 0
