"""Platform probes: the CUDA kernels of csrc/probes.cu and their plain
PyTorch versions.

The H100 counterparts of the four Pallas probes of scripts/probe_tpu.py
(`run_c`, `run_e`, `run_f`, `run_d`), which `scripts/probe_gpu.py` times.
Each computes a defined result at the TPU probe's shapes:

    smem_copy(a)      out = fl(fl(a * 1.0001) * 1.0001)        (1, 576, 896) f32
    block_step(a)     out = a + 1, one writer a value          (1, 8, 128) f32
    hbm_stream(a)     out = sum_g a[g] in f32, in g order      (256, 576, 896) bf16
    dyn_slice(a)      out[0, r] = sum over steps x offsets q_k of a[0, q_k + r]
                      for r < qv, in that order; zero below   (1, 576, 896) f32

The TPU's `run_f` and `run_d` add into an output they never initialise;
here the output starts at zero.  Every sum is a chain of f32 additions in a
fixed order, so each kernel equals its plain version exactly.  A CPU tensor
runs the plain version; a CUDA tensor launches the kernel.  `hbm_stream` and
`smem_copy` launch one persistent block an SM and pass each its slice
(`stream_plan`); `dyn_slice` passes its offsets and an even split of its
items over the SMs (`dyn_slice_plan`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import _build

_c_void_p, _c_int, _c_int64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
SCALE = float(np.float32(1.0001))   # the f32 constant of run_c
PASSES, REPS = 64, 4                # run_c: 64 grid steps of R = 4 round trips
N_BLOCKS = 4096                     # run_e: 4096 grid steps
MAX_SLICES = 256                    # kMaxSlices of csrc/probes.cu: blocks of a plan
QV, N_OFFSETS, STEPS = 168, 20, 64  # run_d: 168-row slices, 20 offsets, 64 steps
MAX_OFFSETS = 512                   # dyn_slice: kMaxOffsets
DYN_STRIP, DYN_BAND = 2, 24         # dyn_slice: float4 columns, output rows an item
MAX_THREADS = 1024                  # threads a block
SMEM_BYTES = 232_448                # shared memory a block may use (227 KB)


def _library() -> ctypes.CDLL:
    lib = _build.load("probes")
    if vars(lib).get("argtypes_set"):
        return lib
    lib.smem_copy.argtypes = [_c_void_p, _c_void_p, _c_int, _c_int, _c_int, _c_int,
                              ctypes.POINTER(_c_int64), _c_void_p]
    lib.block_step.argtypes = [_c_void_p, _c_void_p, _c_int, _c_int, _c_void_p]
    lib.hbm_stream.argtypes = [_c_void_p, _c_void_p, _c_int, _c_int64, _c_int,
                               ctypes.POINTER(_c_int64), _c_void_p]
    lib.dyn_slice.argtypes = ([_c_void_p, _c_void_p] + [_c_int] * 5 + [ctypes.POINTER(_c_int)]
                              + [_c_int] * 5 + [ctypes.POINTER(_c_int), _c_void_p])
    for fn in (lib.smem_copy, lib.block_step, lib.hbm_stream, lib.dyn_slice):
        fn.restype = _c_int
    lib.argtypes_set = True
    return lib


def _check(a: torch.Tensor, dtype: torch.dtype, multiple: int, what: str) -> bool:
    """Validate a probe input; True when it lies on a CUDA device."""
    if a.dtype != dtype or not a.is_contiguous():
        raise TypeError(f"{what}: input must be contiguous {dtype}, got {a.dtype}")
    if a.numel() % multiple:
        raise ValueError(f"{what}: input size {a.numel()} is not a multiple of {multiple}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {a.device}")
    if a.device.type == "cuda" and a.data_ptr() % 16:
        raise ValueError(f"{what}: the kernel loads 16 bytes at a time; input must be "
                         "16-byte aligned")
    return a.device.type == "cuda"


def _stream(a: torch.Tensor) -> int:
    return torch.cuda.current_stream(a.device).cuda_stream


def stream_plan(n8: int, n_sms: int) -> list:
    """hbm_stream's and smem_copy's split of n8 vectors of 16 bytes over
    min(n8, n_sms) persistent blocks: [(start, length)] of contiguous
    slices, in order, the first n8 % n_blocks one vector longer.  The
    kernel's block i takes slice i of this plan."""
    if n8 < 1 or n_sms < 1:
        raise ValueError(f"stream_plan needs n8, n_sms >= 1, got {n8}, {n_sms}")
    n_blocks = min(n8, n_sms)
    base, extra = divmod(n8, n_blocks)
    return [(i * base + min(i, extra), base + (i < extra)) for i in range(n_blocks)]


@functools.lru_cache(maxsize=None)
def _plan_starts(n8: int, n_sms: int) -> tuple:
    """`stream_plan` as the kernel takes it: (slices, C array of the slices'
    starts and n8)."""
    plan = stream_plan(n8, min(n_sms, MAX_SLICES))
    return len(plan), (_c_int64 * (len(plan) + 1))(*(start for start, _ in plan), n8)


def _n_sms(a: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(a.device).multi_processor_count


def offsets(h: int, qv: int = QV, n_offsets: int = N_OFFSETS) -> list:
    """dyn_slice's row offsets: ((29 k) mod (h - qv)) // 8 * 8, k < n_offsets."""
    return [((k * 29) % (h - qv)) // 8 * 8 for k in range(n_offsets)]


@dataclasses.dataclass(frozen=True)
class DynSlicePlan:
    """How dyn_slice's kernel covers a (H, W) input: items of `strip` float4
    columns by `band` output rows, item i on band i % n_bands of strip
    i // n_bands; block b runs items starts[b] .. starts[b + 1] - 1, `batch`
    at a time, and for each strip a batch reaches it stages once the rows
    that its rows of the strip reach.  `staged` states the kernel's staging
    rule, by which the plan sizes the shared memory it passes."""
    qv: int
    w4: int           # float4 columns of a row, ceil(W / 4)
    strip: int
    band: int
    n_strips: int
    n_bands: int
    q_min: int
    span: int         # max q - min q
    batch: int
    threads: int
    smem_bytes: int
    starts: tuple

    @property
    def n_items(self) -> int:
        return self.n_strips * self.n_bands

    def batches(self):
        """Each batch's first and last item + 1, in the kernel's order."""
        for b in range(len(self.starts) - 1):
            for b0 in range(self.starts[b], self.starts[b + 1], self.batch):
                yield b0, min(b0 + self.batch, self.starts[b + 1])

    def rows(self, i: int) -> range:
        """Item i's output rows."""
        b = i % self.n_bands
        return range(b * self.band, min((b + 1) * self.band, self.qv))

    def staged(self, b0: int, b1: int) -> dict:
        """The rows of `a` a batch stages, by strip."""
        strips = {}
        for i in range(b0, b1):
            rows = self.rows(i)
            lo, hi = strips.get(i // self.n_bands, (rows.start, rows.stop))
            strips[i // self.n_bands] = (min(lo, rows.start), max(hi, rows.stop))
        return {s: range(lo + self.q_min, hi + self.q_min + self.span)
                for s, (lo, hi) in strips.items()}

    def item(self, i: int) -> tuple:
        """Item i's output rows, float4 columns and the rows of `a` its batch
        stages for its strip, each as range."""
        s = i // self.n_bands
        b0, b1 = next((b0, b1) for b0, b1 in self.batches() if b0 <= i < b1)
        return (self.rows(i), range(s * self.strip, min((s + 1) * self.strip, self.w4)),
                self.staged(b0, b1)[s])


def dyn_slice_plan(h: int, w: int, qv: int, offs: list, n_sms: int, strip: int = DYN_STRIP,
                   band: int = DYN_BAND) -> DynSlicePlan:
    """dyn_slice's items over min(items, n_sms, MAX_SLICES) persistent blocks
    (`stream_plan`'s even split); a block stages as many of its items at
    once as fit 1,024 threads and 227 KB.  Raises ValueError where a strip
    of one item's rows and the rows its offsets reach do not fit, or a band
    of a strip needs more threads."""
    if not 0 < qv < h or w < 1 or not 1 <= len(offs) <= MAX_OFFSETS or n_sms < 1:
        raise ValueError(f"dyn_slice_plan: no plan for H={h}, W={w}, qv={qv}, "
                         f"{len(offs)} offsets, {n_sms} SMs")
    if min(offs) < 0 or max(offs) > h - qv:
        raise ValueError(f"dyn_slice_plan: offsets must lie in [0, {h - qv}]")
    w4 = -(-w // 4)
    strip, band = min(strip, w4), min(band, qv)
    span = max(offs) - min(offs)
    n_strips, n_bands = -(-w4 // strip), -(-qv // band)
    split = stream_plan(n_strips * n_bands, min(n_sms, MAX_SLICES))
    starts = tuple(start for start, _ in split) + (n_strips * n_bands,)
    plan = None
    for batch in range(min(max(n for _, n in split), MAX_THREADS // (strip * band)), 0, -1):
        plan = DynSlicePlan(qv=qv, w4=w4, strip=strip, band=band, n_strips=n_strips,
                            n_bands=n_bands, q_min=min(offs), span=span, batch=batch,
                            threads=-(-batch * strip * band // 32) * 32, smem_bytes=0,
                            starts=starts)
        smem = max(16 * strip * sum(len(r) for r in plan.staged(b0, b1).values())
                   for b0, b1 in plan.batches())
        if smem <= SMEM_BYTES:
            return dataclasses.replace(plan, smem_bytes=smem)
    raise ValueError(f"dyn_slice_plan: an item of {strip} float4 x {band} rows and the "
                     f"{span} rows its offsets reach do not fit {SMEM_BYTES} bytes "
                     f"(or {MAX_THREADS} threads)")


@functools.lru_cache(maxsize=None)
def _dyn_slice_args(h: int, w: int, qv: int, n_offsets: int, n_sms: int,
                    strip: int = DYN_STRIP, band: int = DYN_BAND) -> tuple:
    """`dyn_slice_plan` at `offsets(h, qv, n_offsets)` and the C arrays the
    kernel takes: (plan, offsets, starts)."""
    offs = offsets(h, qv, n_offsets)
    plan = dyn_slice_plan(h, w, qv, offs, n_sms, strip, band)
    return plan, (_c_int * len(offs))(*offs), (_c_int * len(plan.starts))(*plan.starts)


def _dyn_slice_kernel(a: torch.Tensor, out: torch.Tensor, steps: int, args: tuple) -> None:
    """Launch dyn_slice's kernel on (1, H, W) CUDA tensors with the plan and
    arrays of `_dyn_slice_args`."""
    plan, offs, starts = args
    _build.check(_library().dyn_slice(a.data_ptr(), out.data_ptr(), a.shape[1], a.shape[2],
                                      plan.qv, steps, len(offs), offs, plan.strip, plan.band,
                                      plan.batch, plan.smem_bytes, len(plan.starts) - 1,
                                      starts, _stream(a)), "dyn_slice")


def smem_copy_reference(a: torch.Tensor) -> torch.Tensor:
    return (a * SCALE) * SCALE


def smem_copy(a: torch.Tensor, passes: int = PASSES, reps: int = REPS) -> torch.Tensor:
    """Stage `a` through shared memory `passes` x `reps` times; returns
    fl(fl(a * 1.0001) * 1.0001) in a's shape.  On the card: one block an SM
    over its slice of `stream_plan`, one float4 a thread."""
    if passes < 1 or reps < 1:
        raise ValueError("passes and reps must be >= 1")
    if not _check(a, torch.float32, 4, "smem_copy"):
        return smem_copy_reference(a)
    out = torch.empty_like(a)
    if a.numel() == 0:   # nothing to launch
        return out
    n_slices, starts = _plan_starts(a.numel() // 4, _n_sms(a))
    _build.check(_library().smem_copy(a.data_ptr(), out.data_ptr(), a.numel(), passes,
                                      reps, n_slices, starts, _stream(a)), "smem_copy")
    smem_copy.launches += 1
    return out


def block_step_reference(a: torch.Tensor) -> torch.Tensor:
    return a + 1.0


def block_step(a: torch.Tensor, n_blocks: int = N_BLOCKS) -> torch.Tensor:
    """out = a + 1 over a small tile (the TPU probe's (1, 8, 128)) by
    `n_blocks` one-warp blocks: block b writes the float4 vectors
    v = b (mod n_blocks), and blocks past the tile's vectors do nothing."""
    if not 1 <= n_blocks <= 2**31 - 1:
        raise ValueError(f"n_blocks must be in [1, 2^31 - 1], got {n_blocks}")
    if not _check(a, torch.float32, 4, "block_step"):
        return block_step_reference(a)
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    _build.check(_library().block_step(a.data_ptr(), out.data_ptr(), a.numel(), n_blocks,
                                       _stream(a)), "block_step")
    block_step.launches += 1
    return out


def hbm_stream_reference(a: torch.Tensor) -> torch.Tensor:
    out = torch.zeros((1, *a.shape[1:]), dtype=torch.float32, device=a.device)
    for g in range(a.shape[0]):
        out[0] += a[g].to(torch.float32)
    return out


def hbm_stream(a: torch.Tensor) -> torch.Tensor:
    """(G, ...) bfloat16 -> (1, ...) float32 sum over G, added in g order.
    On the card: one block an SM over its slice of `stream_plan`, four rows
    in flight through a ring in shared memory."""
    if a.ndim < 2 or a[0].numel() % 8:
        raise ValueError(f"hbm_stream: input must be (G, ...) with a multiple of 8 "
                         f"values per block, got {tuple(a.shape)}")
    if not _check(a, torch.bfloat16, 1, "hbm_stream"):
        return hbm_stream_reference(a)
    if a.numel() == 0:
        return torch.zeros((1, *a.shape[1:]), dtype=torch.float32, device=a.device)
    out = torch.empty((1, *a.shape[1:]), dtype=torch.float32, device=a.device)
    n_slices, starts = _plan_starts(out.numel() // 8, _n_sms(a))
    _build.check(_library().hbm_stream(a.data_ptr(), out.data_ptr(), a.shape[0],
                                       out.numel(), n_slices, starts, _stream(a)),
                 "hbm_stream")
    hbm_stream.launches += 1
    return out


def dyn_slice_reference(a: torch.Tensor, qv: int = QV, n_offsets: int = N_OFFSETS,
                        steps: int = STEPS) -> torch.Tensor:
    out = torch.zeros_like(a)
    rows = offsets(a.shape[1], qv, n_offsets)
    for _ in range(steps):
        for q in rows:
            out[0, :qv] += a[0, q:q + qv]
    return out


def dyn_slice(a: torch.Tensor, qv: int = QV, n_offsets: int = N_OFFSETS,
              steps: int = STEPS) -> torch.Tensor:
    """(1, H, W) float32: the first `qv` output rows sum `steps` x
    `n_offsets` row slices of `a` at `offsets(H, qv, n_offsets)`; the rest
    are zero.  On the card: one launch, items of `dyn_slice_plan` staged in
    shared memory and read back 16 bytes at a time."""
    if a.ndim != 3 or a.shape[0] != 1 or not 0 < qv < a.shape[1]:
        raise ValueError(f"dyn_slice: input must be (1, H, W) with H > qv = {qv}, "
                         f"got {tuple(a.shape)}")
    if not 1 <= n_offsets <= MAX_OFFSETS or not 1 <= steps * n_offsets < 2**31:
        raise ValueError(f"dyn_slice: needs 1 to {MAX_OFFSETS} offsets and 1 to 2^31 - 1 "
                         f"terms, got {n_offsets} offsets and {steps} steps")
    if not _check(a, torch.float32, 1, "dyn_slice"):
        return dyn_slice_reference(a, qv, n_offsets, steps)
    _, H, W = a.shape
    out = torch.empty_like(a)
    if W == 0:
        return out
    _dyn_slice_kernel(a, out, steps, _dyn_slice_args(H, W, qv, n_offsets, _n_sms(a)))
    dyn_slice.launches += 1
    return out


smem_copy.launches = 0
block_step.launches = 0
hbm_stream.launches = 0
dyn_slice.launches = 0
