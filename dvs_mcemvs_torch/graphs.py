"""CUDA-graph programs: the machinery that the chunk programs
(`mapper.evaluate_dsi`) and the sharded step programs (`parallel.sharded`)
share, the counterpart of the JAX package's `jax.jit`.

A program owns a body's static inputs on the card and the CUDA graphs
captured from it.  `Graph` captures a function once into the device's one
memory pool, and each replay adds the kernel launches its capture recorded;
`warm_up` runs the body eagerly on a side stream before the first capture
(building the kernels, filling the plan and table caches); `Staging` moves a
call's host arrays into static buffers through two pinned buffers used in
turn; `ProgramCache` keeps the programs of a kind, dropping the least
recently used.  `eager()` turns every program off on its thread (the
counterpart of `jax.disable_jit()`).

A body reads nothing back from the card: the binning's weight checks set a
per-device fault flag (`fault_flag`), which `check_faults` reads once a
chunk or step.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Callable, Dict, Iterator, List

import numpy as np
import torch

from .kernels import binning, resample

# The kernel wrappers a body reaches, whose launch counts a replay adds.
COUNTED = (binning.bin_events, resample.banded_resample_sum, resample.banded_resample_fanin)

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
    for flag in pending:
        binning.raise_weight_faults(flag)


# ---------------------------------------------------------------------------
# Programs
# ---------------------------------------------------------------------------


class ProgramCache:
    """A least-recently-used map of programs, closing each it drops."""

    def __init__(self, size: int):
        self.size = size
        self._items: "collections.OrderedDict[tuple, object]" = collections.OrderedDict()

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

    def clear(self) -> None:
        while self._items:
            self._items.popitem(last=False)[1].close()


_POOLS: Dict[torch.device, tuple] = {}
_SIDE: Dict[torch.device, torch.cuda.Stream] = {}


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


def warm_up(device: torch.device, fn: Callable, flag: torch.Tensor):
    """fn() run eagerly on the device's side stream under deferred weight
    checks into `flag`, before its first capture; the caller's stream waits
    for it.  Returns fn()'s result, its tensors marked in use on the
    caller's stream."""
    cur = torch.cuda.current_stream(device)
    if device not in _SIDE:
        _SIDE[device] = torch.cuda.Stream(device)
    side = _SIDE[device]
    side.wait_stream(cur)
    with torch.cuda.stream(side), binning.deferred_weight_checks(flag):
        out = fn()
    cur.wait_stream(side)
    for t in _tensors(out):
        t.record_stream(cur)
    return out


class Graph:
    """fn() captured in a CUDA graph on `device`'s memory pool, under
    deferred weight checks into `flag`.

    `out` is the capture's result, static tensors that every replay
    rewrites; `tables` are the kernel-B tables the graph reads, held while
    it lives.  Every graph of a device shares one pool: replays run in
    order on the caller's stream and a program copies what it returns
    right after its last replay, so one graph's temporaries may reuse
    another's memory.  The launch counts that the capture recorded are
    taken back, and added at every replay.  The class counts the process's
    captures and replays."""

    captures_total = 0
    replays_total = 0

    def __init__(self, device: torch.device, fn: Callable, flag: torch.Tensor):
        if device not in _POOLS:
            _POOLS[device] = torch.cuda.graph_pool_handle()
        before = {f: f.launches for f in COUNTED}
        self.graph = torch.cuda.CUDAGraph()
        try:
            with resample.tables_in_use() as self.tables, \
                    binning.deferred_weight_checks(flag), \
                    torch.cuda.graph(self.graph, pool=_POOLS[device],
                                     capture_error_mode="thread_local"):
                self.out = fn()
        finally:
            self.launches = {f: f.launches - n for f, n in before.items()}
            for f, n in before.items():
                f.launches = n
        Graph.captures_total += 1

    def replay(self) -> None:
        self.graph.replay()
        Graph.replays_total += 1
        for f, n in self.launches.items():
            f.launches += n


class Staging:
    """Host arrays into the static device `buffers` through two pinned host
    buffer sets used in turn: a load fills the set not in flight (waiting
    for that set's last copies first) and queues its copies on the current
    stream."""

    def __init__(self, buffers: List[torch.Tensor]):
        self.buffers = buffers
        self.host = [[torch.empty(b.shape, dtype=b.dtype, pin_memory=True) for b in buffers]
                     for _ in range(2)]
        self.copied = [None, None]  # the event after each set's copies
        self.loads = 0

    def load(self, fill: Callable[[List[np.ndarray]], None]) -> None:
        """fill(host) writes the call's data into `host`, numpy views of one
        pinned set; then its copies into the buffers are queued."""
        slot = self.loads % 2
        self.loads += 1
        if self.copied[slot] is not None:
            self.copied[slot].synchronize()
        host = self.host[slot]
        fill([h.numpy() for h in host])
        for dst, src in zip(self.buffers, host):
            dst.copy_(src, non_blocking=True)
        self.copied[slot] = torch.cuda.Event()
        self.copied[slot].record()
