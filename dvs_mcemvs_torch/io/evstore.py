"""Python binding of the native event store (native/evstore.cpp).

Port of dvs_mcemvs_tpu/io/evstore.py.  The store replaces the reference's
per-chunk rosbag re-parsing (src/main.cpp:191-199 re-reads the input bags
for every sliding-window chunk) with a one-time ingest into a columnar mmap
file; windows are O(log E) native binary searches and the next chunk's
pages are warmed by a background prefetch thread while the device computes
the current one.

The shared library is built on first use with g++ from the unchanged
native/evstore.cpp into the git-ignored build/native/ (never into native/),
each build written to a temporary name and renamed into place, so
processes that build at once do not read a half-written library.  Callers
treat the store as an optional acceleration: without a compiler the build
raises and they keep the numpy path.

Timestamp precision: the store keeps a f64 epoch `t0` plus f32 seconds
RELATIVE to it, so absolute (epoch-scale) offsets lose nothing, but within
a recording the resolution degrades linearly with elapsed time — ~0.24 ms
at t-t0=2000 s, ~0.43 ms at one hour (eps = (t-t0) * 2^-23).  Window
boundaries and packet mid-times therefore quantize differently from the
f64 numpy path (`Events.time_window`) by up to that amount; DSEC's own
`ms_to_idx` index is 1 ms-granular, so the store stays strictly finer than
the dataset's native lookup at any recording length
(tests/test_evstore.py::test_hour_scale_quantization).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

from ..mapper import Events

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "evstore.cpp")
_SO = os.path.join(_REPO, "build", "native", "libevstore.so")

_lib = None


def _build_library() -> str:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    if (not os.path.exists(_SO)
            or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
        tmp = f"{_SO}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-fPIC",
               "-Wall", _SRC, "-shared", "-pthread", "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, _SO)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return _SO


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_build_library())
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.evs_create.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_uint64]
    lib.evs_create.restype = ctypes.c_int
    lib.evs_open.argtypes = [ctypes.c_char_p]
    lib.evs_open.restype = ctypes.c_void_p
    lib.evs_close.argtypes = [ctypes.c_void_p]
    lib.evs_count.argtypes = [ctypes.c_void_p]
    lib.evs_count.restype = ctypes.c_uint64
    lib.evs_t0.argtypes = [ctypes.c_void_p]
    lib.evs_t0.restype = ctypes.c_double
    lib.evs_t1.argtypes = [ctypes.c_void_p]
    lib.evs_t1.restype = ctypes.c_double
    lib.evs_window.argtypes = [ctypes.c_void_p, ctypes.c_double,
                               ctypes.c_double, u64p, u64p]
    lib.evs_window_inclusive.argtypes = lib.evs_window.argtypes
    lib.evs_read.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                             ctypes.c_uint64, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p]
    lib.evs_prefetch.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                 ctypes.c_double]
    lib.evs_prefetch.restype = ctypes.c_int
    lib.evs_prefetch_busy.argtypes = [ctypes.c_void_p]
    lib.evs_prefetch_busy.restype = ctypes.c_int
    _lib = lib
    return lib


def write_store(path: str, events: Events) -> None:
    """Ingest an event stream (absolute seconds, sorted) into a store file."""
    lib = _load()
    n = events.num
    t = np.ascontiguousarray(events.t, np.float64)
    x = np.ascontiguousarray(events.x, np.uint16)
    y = np.ascontiguousarray(events.y, np.uint16)
    p = (np.ascontiguousarray(events.p, np.int8)
         if events.p is not None else None)
    rc = lib.evs_create(
        path.encode(), t.ctypes.data_as(ctypes.c_void_p),
        x.ctypes.data_as(ctypes.c_void_p), y.ctypes.data_as(ctypes.c_void_p),
        p.ctypes.data_as(ctypes.c_void_p) if p is not None else None,
        ctypes.c_uint64(n))
    if rc != 0:
        raise OSError(f"evs_create({path}) failed with {rc}")


class EventStore:
    """Open store: O(log E) windows, zero-copy reads, async prefetch."""

    def __init__(self, path: str):
        self._lib = _load()
        self._h = self._lib.evs_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open event store {path}")
        self.path = path

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.evs_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - gc timing
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def count(self) -> int:
        return int(self._lib.evs_count(self._h))

    @property
    def time_range(self) -> Tuple[float, float]:
        return (float(self._lib.evs_t0(self._h)),
                float(self._lib.evs_t1(self._h)))

    def window_indices(self, t0: float, t1: float,
                       inclusive_end: bool = True) -> Tuple[int, int]:
        lo = ctypes.c_uint64()
        hi = ctypes.c_uint64()
        fn = (self._lib.evs_window_inclusive if inclusive_end
              else self._lib.evs_window)
        fn(self._h, ctypes.c_double(t0), ctypes.c_double(t1),
           ctypes.byref(lo), ctypes.byref(hi))
        return int(lo.value), int(hi.value)

    def read(self, lo: int, hi: int) -> Events:
        """Decode [lo, hi) into an Events batch (t absolute seconds)."""
        n = max(0, hi - lo)
        x = np.empty(n, np.int32)
        y = np.empty(n, np.int32)
        t = np.empty(n, np.float32)
        p = np.empty(n, np.int8)
        self._lib.evs_read(
            self._h, ctypes.c_uint64(lo), ctypes.c_uint64(hi),
            x.ctypes.data_as(ctypes.c_void_p), y.ctypes.data_as(ctypes.c_void_p),
            t.ctypes.data_as(ctypes.c_void_p), p.ctypes.data_as(ctypes.c_void_p))
        t0, _ = self.time_range
        return Events(x, y, t.astype(np.float64) + t0, p)

    def window(self, t0: float, t1: float) -> Events:
        """Events with t in [t0, t1] (matching Events.time_window)."""
        lo, hi = self.window_indices(t0, t1)
        return self.read(lo, hi)

    def prefetch(self, t0: float, t1: float) -> bool:
        """Start warming the pages of a future window; non-blocking."""
        return bool(self._lib.evs_prefetch(
            self._h, ctypes.c_double(t0), ctypes.c_double(t1)))

    @property
    def prefetch_busy(self) -> bool:
        return bool(self._lib.evs_prefetch_busy(self._h))


def write_store_streaming(path: str, source, chunk: int = 4 << 20) -> None:
    """Stream a whole time-sorted event file into a store with O(chunk)
    peak memory: the CLI never materializes an hour-scale DSEC stream
    (1e9+ events, 13+ GB of columns) in RAM.

    `source` is any object with `count`, `time_at(i)` and
    `read(lo, hi, cols)` (io/events.H5EventSource).  The store layout is
    columnar (native/evstore.cpp header), so the file is written in four
    sequential single-column passes; each pass reads O(chunk) elements at a
    time.  Timestamps are stored as absolute epoch t0 + f32 relative
    seconds, exactly like `write_store`.
    """
    import struct

    n = int(source.count)
    t0 = source.time_at(0) if n else 0.0
    t1 = source.time_at(n - 1) if n else 0.0
    with open(path, "wb") as f:
        f.write(b"EVST0001")
        f.write(struct.pack("<Q", n))
        f.write(struct.pack("<d", t0))
        f.write(struct.pack("<d", t1))
        prev_last = -np.inf
        for lo in range(0, n, chunk):
            hi = min(n, lo + chunk)
            _, _, t, _ = source.read(lo, hi, cols="t")
            if t[0] < prev_last or np.any(np.diff(t) < 0):
                raise ValueError(
                    f"{getattr(source, 'path', '?')} is not time-sorted; "
                    "streaming ingest requires sorted input")
            prev_last = t[-1]
            (t - t0).astype(np.float32).tofile(f)
        for ci, col in ((0, "x"), (1, "y")):
            for lo in range(0, n, chunk):
                hi = min(n, lo + chunk)
                vals = source.read(lo, hi, cols=col)[ci]
                vals.astype(np.uint16).tofile(f)
        for lo in range(0, n, chunk):
            hi = min(n, lo + chunk)
            _, _, _, p = source.read(lo, hi, cols="p")
            if p is None:
                np.zeros(hi - lo, np.int8).tofile(f)
            else:
                p.astype(np.int8).tofile(f)


class NormalizedStore:
    """View of an absolute-time EventStore in the run's normalized frame
    (per-camera `offset` + shared TimeOrigin), the streaming replacement
    for loading + normalizing the whole stream up front.

    normalized_t = absolute_t + offset - origin.t0; window queries convert
    the other way.  Duck-types EventStore's window/prefetch/count surface,
    so pipeline.run_full_seq_stores drives it unchanged.
    """

    def __init__(self, store: EventStore, offset: float = 0.0, origin=None):
        self.store = store
        if origin is not None and origin.t0 is None:
            origin.t0 = store.time_range[0] + offset
        self.delta = offset - (origin.t0 if origin is not None else 0.0)

    @property
    def count(self) -> int:
        return self.store.count

    @property
    def time_range(self):
        a, b = self.store.time_range
        return a + self.delta, b + self.delta

    def window(self, t0: float, t1: float) -> Events:
        ev = self.store.window(t0 - self.delta, t1 - self.delta)
        return Events(ev.x, ev.y, ev.t + self.delta, ev.p)

    def window_count(self, t0: float, t1: float) -> int:
        lo, hi = self.store.window_indices(t0 - self.delta, t1 - self.delta)
        return hi - lo

    def head(self, n: int, t0: float, t1: float) -> Events:
        """First min(n, window) events of a window (preview imaging)."""
        lo, hi = self.store.window_indices(t0 - self.delta, t1 - self.delta)
        ev = self.store.read(lo, min(hi, lo + n))
        return Events(ev.x, ev.y, ev.t + self.delta, ev.p)

    def prefetch(self, t0: float, t1: float) -> bool:
        return self.store.prefetch(t0 - self.delta, t1 - self.delta)


def cache_path_for(source_path: str) -> str:
    return source_path + ".evs"


def open_or_build_h5(source_path: str, chunk: int = 4 << 20) -> EventStore:
    """Open the .evs cache next to an HDF5 event file, stream-building it
    with O(chunk) memory on first use (or when the source is newer)."""
    cache = cache_path_for(source_path)
    fresh = (os.path.exists(cache)
             and os.path.getmtime(cache) >= os.path.getmtime(source_path))
    if not fresh:
        from .events import H5EventSource

        with H5EventSource(source_path) as src:
            write_store_streaming(cache, src, chunk)
    return EventStore(cache)


def open_or_build(source_path: str, events: Optional[Events] = None) -> EventStore:
    """Open the .evs cache next to `source_path`, ingesting once if absent
    (or stale).  `events` supplies the decoded stream on first build."""
    cache = cache_path_for(source_path)
    fresh = (os.path.exists(cache)
             and os.path.getmtime(cache) >= os.path.getmtime(source_path))
    if not fresh:
        if events is None:
            raise ValueError(f"no cache at {cache} and no events provided")
        write_store(cache, events)
    return EventStore(cache)
