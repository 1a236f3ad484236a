"""CUDA-graph programs: the machinery that the chunk programs
(`mapper.evaluate_dsi`), the whole-chunk programs (`mapper.get_depth_map`'s
extraction, `pipeline`'s fusion and temporal steps) and the sharded step
programs (`parallel.sharded`) share, the counterpart of the JAX package's
`jax.jit`.

A program owns a body's static inputs on the card and the CUDA graphs
captured from it.  `Graph` captures a function once into the device's one
memory pool, and each replay adds the kernel launches its capture recorded;
`warm_up` runs the body eagerly on a side stream before the first capture
(building the kernels, filling the plan and table caches); `Staging` moves a
call's host arrays into static buffers through two pinned buffers used in
turn; `PageLocks` page-locks in place the host arrays that a run slices its
chunks from, once a process, so that a chunk is copied to the card by DMA
with no copy on the host; `Captured` is the program of a body over static
device tensors (the caller's tensors copied in on the card, fresh copies
of the result out); `ProgramCache` keeps the programs of a kind, dropping
the least recently used.  `eager()` turns every program off on its thread
(the counterpart of `jax.disable_jit()`).

A body reads nothing back from the card: the binning's weight checks set a
per-device fault flag (`fault_flag`), which `check_faults` reads once a
chunk or step.

The counters (the graphs' captures and replays, the caches' evictions, the
counted wrappers' launches) are updated under `tracing.COUNTS`, so that
threads lose no update; a program's call and first call are the tracer's
`replay.<kind>` and `capture.<kind>` spans, and a replay, a program's input
copies and a staging's copies mark where their device work starts to be
queued (`tracing.mark`).
"""

from __future__ import annotations

import collections
import contextlib
import mmap
import threading
import weakref
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from . import tracing
from .kernels import binning, resample, scatter

# The kernel wrappers a body reaches, whose launch counts a replay adds.
COUNTED = (binning.bin_events, resample.banded_resample_sum, resample.banded_resample_fanin,
           scatter.scatter_vote)

_eager = threading.local()


@contextlib.contextmanager
def eager() -> Iterator[None]:
    """Inside (on this thread), the programs are off: `mapper.evaluate_dsi`
    and the sharded steps run their bodies eagerly on the card, as the JAX
    package's `jax.disable_jit()` does."""
    prev = getattr(_eager, "on", False)
    _eager.on = True
    try:
        yield
    finally:
        _eager.on = prev


def use_programs(device: torch.device) -> bool:
    """Whether a call on `device` runs a program: on a CUDA device, outside
    `eager()`."""
    return device.type == "cuda" and not getattr(_eager, "on", False)


# ---------------------------------------------------------------------------
# The fault flags of the deferred weight checks
# ---------------------------------------------------------------------------

_FAULTS: Dict[torch.device, torch.Tensor] = {}
_PENDING: set = set()
_FAULTS_LOCK = threading.Lock()


def fault_flag(device: torch.device) -> torch.Tensor:
    """The device's fault flag, which every body there sets (made once,
    outside any capture)."""
    with _FAULTS_LOCK:
        if device not in _FAULTS:
            _FAULTS[device] = binning.fault_flag(device)
        return _FAULTS[device]


def mark_pending(device: torch.device) -> None:
    """A body ran on `device`: the next `check_faults` reads its flag."""
    with _FAULTS_LOCK:
        _PENDING.add(device)


def check_faults() -> None:
    """Raise the binning's ValueError if a body run since the last check
    had weights its mode refuses (`binning.WEIGHT_FAULTS`): one read of each
    device's fault flag where a body ran since."""
    with _FAULTS_LOCK:
        pending = [_FAULTS[d] for d in _PENDING]
        _PENDING.clear()
    if pending:
        with tracing.span("wait.faults"):
            for flag in pending:
                binning.raise_weight_faults(flag)


# ---------------------------------------------------------------------------
# Programs
# ---------------------------------------------------------------------------


class ProgramCache:
    """A least-recently-used map of programs, closing each it drops.  Each
    thread has a map of its own: a thread's programs live in its own graph
    pool (`Graph`), so threads that run programs at once (the CLI's save
    workers extract depth maps beside the main thread's chunks) never
    replay graphs that share memory.  The class counts the programs that
    its maps drop."""

    evictions_total = 0

    def __init__(self, size: int):
        self.size = size
        self._local = threading.local()

    @property
    def _items(self) -> "collections.OrderedDict[tuple, object]":
        items = getattr(self._local, "items", None)
        if items is None:
            items = self._local.items = collections.OrderedDict()
        return items

    def __len__(self) -> int:
        return len(self._items)

    def keys(self) -> list:
        return list(self._items)

    def values(self) -> list:
        return list(self._items.values())

    def get(self, key):
        prog = self._items.get(key)
        if prog is not None:
            self._items.move_to_end(key)
        return prog

    def put(self, key, prog) -> None:
        self._items[key] = prog
        self._items.move_to_end(key)
        while len(self._items) > self.size:
            _, old = self._items.popitem(last=False)
            old.close()
            with tracing.COUNTS:
                ProgramCache.evictions_total += 1

    def clear(self) -> None:
        while self._items:
            self._items.popitem(last=False)[1].close()

    def call(self, key, make: Callable[[], "Captured"], *tensors):
        """The program of `key` called on `tensors`, made by `make()` on
        first use; a program whose first call raises is not kept."""
        prog = self.get(key)
        if prog is not None:
            return prog(*tensors)
        prog = make()
        out = prog(*tensors)
        self.put(key, prog)
        return out


_streams = threading.local()
# One capture at a time in the process (`_capture`).
_CAPTURE_LOCK = threading.Lock()


def _thread_streams(device: torch.device) -> dict:
    """This thread's graph memory pool, warm-up stream and capture stream on
    `device`, made on first use.  The pool keeps a one-kernel anchor graph:
    PyTorch frees a pool with its last graph and refuses its handle after,
    so without it no program could be captured once every cache was
    cleared."""
    per_device = getattr(_streams, "per_device", None)
    if per_device is None:
        per_device = _streams.per_device = {}
    if device not in per_device:
        st = dict(pool=torch.cuda.graph_pool_handle(), side=torch.cuda.Stream(device),
                  capture=torch.cuda.Stream(device), anchor=torch.cuda.CUDAGraph())
        with _capture(st["anchor"], st):
            torch.zeros(1, device=device)
        per_device[device] = st
    return per_device[device]


@contextlib.contextmanager
def _capture(graph: torch.cuda.CUDAGraph, streams: dict) -> Iterator[None]:
    """`graph` captures what runs inside, on this thread's capture stream
    and pool (`_thread_streams`), one capture at a time in the process.
    (`torch.cuda.graph` would also synchronise the device and empty the
    allocator's caches before each capture, so that every later allocation
    of the process paid a new cudaMalloc.)"""
    with _CAPTURE_LOCK, torch.cuda.stream(streams["capture"]):
        graph.capture_begin(pool=streams["pool"], capture_error_mode="thread_local")
        try:
            yield
        finally:
            graph.capture_end()


def _tensors(tree) -> Iterator[torch.Tensor]:
    """The tensors of a result: a tensor, or a dict, list or tuple of them."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def fresh(tree):
    """A copy of every tensor of a result (a tensor, or a dict, list or
    tuple of them), so that the next replay cannot change it."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: fresh(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(fresh(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(fresh(v) for v in tree)
    return tree


def warm_up(device: torch.device, fn: Callable, flag: torch.Tensor):
    """fn() run eagerly on the device's side stream under deferred weight
    checks into `flag`, before its first capture; the caller's stream waits
    for it.  Returns fn()'s result, its tensors marked in use on the
    caller's stream."""
    cur = torch.cuda.current_stream(device)
    side = _thread_streams(device)["side"]
    side.wait_stream(cur)
    with torch.cuda.stream(side), binning.deferred_weight_checks(flag):
        out = fn()
    cur.wait_stream(side)
    for t in _tensors(out):
        t.record_stream(cur)
    return out


class Graph:
    """fn() captured in a CUDA graph on this thread's memory pool of
    `device`, on its capture stream, under deferred weight checks into
    `flag`.

    `out` is the capture's result, static tensors that every replay
    rewrites; `tables` are the kernel-B tables the graph reads, held while
    it lives.  Every graph that a thread captures on a device shares one
    pool: the thread replays them in order on its current stream and a
    program copies what it returns right after its last replay, so one
    graph's temporaries may reuse another's memory.  (A thread replays only
    its own programs: `ProgramCache` keeps them per thread.)  The launch
    counts that the capture recorded (`tracing.held_launches`) are added
    at every replay.  The class counts the process's captures and
    replays."""

    captures_total = 0
    replays_total = 0

    def __init__(self, device: torch.device, fn: Callable, flag: torch.Tensor):
        streams = _thread_streams(device)
        self.graph = torch.cuda.CUDAGraph()
        with tracing.held_launches() as held, resample.tables_in_use() as self.tables, \
                binning.deferred_weight_checks(flag), _capture(self.graph, streams):
            self.out = fn()
        self.launches = {f: held.get(f, 0) for f in COUNTED}
        with tracing.COUNTS:
            Graph.captures_total += 1

    def replay(self) -> None:
        tracing.mark()
        self.graph.replay()
        with tracing.COUNTS:
            Graph.replays_total += 1
            for f, n in self.launches.items():
                f.launches += n


class Staging:
    """Host arrays into the static device `buffers` through two pinned host
    buffer sets used in turn, made on the first load: a load fills the set
    not in flight (waiting for that set's last copies first) and queues its
    copies on the current stream."""

    def __init__(self, buffers: List[torch.Tensor]):
        self.buffers = buffers
        self.host: Optional[List[List[torch.Tensor]]] = None
        self.copied = [None, None]  # the event after each set's copies
        self.loads = 0

    def load(self, fill: Callable[[List[np.ndarray]], None]) -> None:
        """fill(host) writes the call's data into `host`, numpy views of one
        pinned set; then its copies into the buffers are queued."""
        if self.host is None:
            self.host = [[torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
                          for b in self.buffers] for _ in range(2)]
        slot = self.loads % 2
        self.loads += 1
        if self.copied[slot] is not None:
            with tracing.span("wait.staging"):
                self.copied[slot].synchronize()
        host = self.host[slot]
        fill([h.numpy() for h in host])
        tracing.mark()
        for dst, src in zip(self.buffers, host):
            dst.copy_(src, non_blocking=True)
        self.copied[slot] = torch.cuda.Event()
        self.copied[slot].record()


# ---------------------------------------------------------------------------
# Host arrays page-locked in place
# ---------------------------------------------------------------------------

# cudaHostRegisterPortable: the pages are locked for every device's context.
_PORTABLE = 1


def _isolated(call: Callable[[], object]) -> object:
    """call() on a thread of its own, its result (None where it raised): a
    CUDA runtime call that fails leaves the error as its thread's last
    error, where the next kernel launch's check on that thread would raise
    it."""
    out = []

    def run():
        try:
            out.append(call())
        except RuntimeError:
            pass

    th = threading.Thread(target=run, name="host-register")
    th.start()
    th.join()
    return out[0] if out else None


def cuda_host_register(ptr: int, size: int) -> bool:
    """Page-lock [ptr, ptr + size) in place for every device
    (cudaHostRegister); False where the call fails."""
    rt = torch.cuda.cudart()
    return _isolated(lambda: rt.cudaHostRegister(ptr, size, _PORTABLE)) == rt.cudaError.success


def cuda_host_unregister(ptr: int, done: Optional[torch.cuda.Event]) -> None:
    """Wait for `done` (the last copy from the range, if any), then release
    the range that `cuda_host_register` locked at `ptr`."""
    def call():
        if done is not None:
            done.synchronize()
        return torch.cuda.cudart().cudaHostUnregister(ptr)

    _isolated(call)


def _owner(a: np.ndarray) -> np.ndarray:
    """The array whose memory `a` views (`a` itself where it is no view)."""
    while isinstance(a.base, np.ndarray):
        a = a.base
    return a


class _Locked:
    """A page-locked range: its first page, and the event after the last
    copies queued from it."""

    __slots__ = ("ptr", "done")

    def __init__(self, ptr: int):
        self.ptr, self.done = ptr, None


class PageLocks:
    """The process's host arrays page-locked in place, so that the chunks
    sliced from them reach the card by DMA with no copy on the host.

    `lock` locks the pages that cover each array's owner (the array whose
    memory it views, or itself) through `register(ptr, size)`, once for
    the process however often it is asked, and releases them through
    `unregister(ptr, done)` as the owner is freed, after the last copies
    from it (`copied`).  An owner that `register` refuses (memory already
    locked, a limit, memory that cannot be locked) is remembered as
    refused.  `locked` only looks: a chunk whose arrays it finds in no
    locked owner is staged as any other.  The arrays must not change while
    the card may still read them."""

    def __init__(self, register: Callable[[int, int], bool] = cuda_host_register,
                 unregister: Callable[[int, Optional[torch.cuda.Event]], None] =
                 cuda_host_unregister):
        self.register, self.unregister = register, unregister
        self._owners: Dict[int, Optional[_Locked]] = {}
        self._lock = threading.RLock()

    def _lock_owner(self, owner: np.ndarray) -> Optional[_Locked]:
        if not owner.flags.c_contiguous or owner.nbytes == 0:
            return None
        start = owner.ctypes.data
        ptr = start - start % mmap.PAGESIZE
        size = -(-(start + owner.nbytes - ptr) // mmap.PAGESIZE) * mmap.PAGESIZE
        if not self.register(ptr, size):
            return None
        tracing.registered(size)
        return _Locked(ptr)

    def _release(self, key: int) -> None:
        with self._lock:
            locked = self._owners.pop(key, None)
        if locked is not None:
            self.unregister(locked.ptr, locked.done)

    def lock(self, *arrays: np.ndarray) -> None:
        """Lock the owners of `arrays` not seen before."""
        with self._lock:
            for a in arrays:
                owner = _owner(a)
                key = id(owner)
                if key not in self._owners:
                    self._owners[key] = self._lock_owner(owner)
                    weakref.finalize(owner, self._release, key).atexit = False

    def locked(self, *arrays: np.ndarray) -> bool:
        """Whether every one of `arrays` is C-contiguous and lies in an owner
        that `lock` locked."""
        with self._lock:
            return all(a.flags.c_contiguous and self._owners.get(id(_owner(a))) is not None
                       for a in arrays)

    def copied(self, device: torch.device, *arrays: np.ndarray) -> None:
        """Copies from `arrays` were just queued on `device`'s current
        stream: their owners are released only after them."""
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        with self._lock:
            for a in arrays:
                locked = self._owners.get(id(_owner(a)))
                if locked is not None:
                    locked.done = done


# The process's page-locked host arrays.
PAGE_LOCKS = PageLocks()


class Captured:
    """body() captured in one CUDA graph on `device`, over the static
    tensors `inputs` that it reads (allocated by the caller, outside the
    graphs' pool, so that no replay's temporaries overwrite them).

    A call copies its tensors into `inputs` on the current stream (device
    to device, or host to device for CPU tensors), then on first use runs
    the body eagerly (`warm_up`) and captures it, or replays the graph;
    it returns fresh copies of the result (`fresh_out=False`: the graph's
    own output, valid until this thread replays another graph of the
    device).  A body that cannot be captured raises.  `kind` names the
    tracer's spans of the program's calls (`replay.<kind>`,
    `capture.<kind>`)."""

    def __init__(self, device: torch.device, inputs: List[torch.Tensor], body: Callable,
                 kind: str = "program"):
        self.device, self.inputs, self.body = device, list(inputs), body
        self.graph: Optional[Graph] = None
        self.capture_s = 0.0
        self.spans = ("replay." + kind, "capture." + kind)

    def __call__(self, *tensors: torch.Tensor, fresh_out: bool = True):
        if len(tensors) != len(self.inputs):
            raise ValueError(f"{len(tensors)} tensors for {len(self.inputs)} static inputs")
        if self.graph is None:
            for dst, src in zip(self.inputs, tensors):
                dst.copy_(src, non_blocking=True)
            with tracing.timed(self.spans[1]) as sp:
                flag = fault_flag(self.device)
                out = warm_up(self.device, self.body, flag)
                self.graph = Graph(self.device, self.body, flag)
            self.capture_s = sp.seconds
            return out
        with tracing.span(self.spans[0], self.device):
            tracing.mark()
            for dst, src in zip(self.inputs, tensors):
                dst.copy_(src, non_blocking=True)
            self.graph.replay()
            return fresh(self.graph.out) if fresh_out else self.graph.out

    def close(self) -> None:
        """Drop the graph once the card is done with it."""
        if self.graph is not None:
            torch.cuda.synchronize(self.device)
        self.graph = None
