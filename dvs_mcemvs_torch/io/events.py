"""Event-stream readers: HDF5 (DSEC / TUM-VIE), npz, text and ROS1 bags.

Port of dvs_mcemvs_tpu/io/events.py (host-side numpy).  Events stay host
arrays; h5py is imported only by the HDF5 readers, and bags are read by
`io/rosbag1.py`.  Besides the reference's rosbag ingest
(mapper_emvs_stereo/src/data_loading.cpp:33-302) it reads the datasets'
native array formats.  The
reference normalizes all timestamps against a hidden function-local static
`initial_timestamp` shared across files (data_loading.cpp:30-31); here that
shared origin is an explicit `TimeOrigin` object threaded through every
reader.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from ..mapper import Events


@dataclasses.dataclass
class TimeOrigin:
    """Explicit replacement for data_loading.cpp's static initial_timestamp:
    the first timestamp seen by any reader becomes t=0 for the whole run."""

    t0: Optional[float] = None

    def normalize(self, t: np.ndarray) -> np.ndarray:
        if self.t0 is None and t.size:
            self.t0 = float(t[0])
        return t - (self.t0 or 0.0)


def _finalize(x, y, t, p, offset: float, t_start: float, t_stop: float,
              origin: Optional[TimeOrigin]) -> Events:
    """Shared tail of every reader: per-camera time offset
    (data_loading.cpp:99), global origin, window crop, and a stable
    sort by timestamp (:212-216)."""
    t = np.asarray(t, np.float64) + offset
    if origin is not None:
        t = origin.normalize(t)
    keep = (t >= t_start) & (t <= t_stop)
    x, y, t = x[keep], y[keep], t[keep]
    p = p[keep] if p is not None else None
    order = np.argsort(t, kind="stable")
    return Events(
        np.ascontiguousarray(x[order], np.int32),
        np.ascontiguousarray(y[order], np.int32),
        np.ascontiguousarray(t[order], np.float64),
        None if p is None else np.ascontiguousarray(p[order], np.int8),
    )


def _h5_bisect(t_ds, raw: float, lo: int, hi: int) -> int:
    """First index in [lo, hi) with t >= raw, via O(log E) single-element
    dataset reads (never materializes the column)."""
    while lo < hi:
        mid = (lo + hi) // 2
        if float(t_ds[mid]) < raw:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _h5_window(g, f, t_start: float, t_stop: float, offset: float,
               origin: Optional[TimeOrigin]):
    """Index range [lo, hi) of the requested normalized-time window,
    touching O(window) + O(log E) elements of the t column.

    Uses the DSEC `ms_to_idx` table when present (ms_to_idx[ms] = first
    index with t >= ms*1000 µs, t relative to t_offset — the lookup the
    reference never had; its loop re-parses whole bags per window,
    main.cpp:191-199) and falls back to bisection on the t dataset.
    """
    t_ds = g["t"]
    n = int(t_ds.shape[0])
    if n == 0:
        return 0, 0, 0.0, 1.0
    t_offset = float(f["t_offset"][()]) if "t_offset" in f else 0.0
    integer_us = np.issubdtype(t_ds.dtype, np.integer)
    scale = 1e-6 if integer_us else 1.0
    shift = t_offset * 1e-6 if integer_us else 0.0

    def phys(raw):  # stored value -> absolute seconds
        return float(raw) * scale + shift

    # The window is expressed in the same frame _finalize crops in: the
    # run origin when one is threaded through, raw time otherwise.
    if origin is None:
        t0 = 0.0
    elif origin.t0 is not None:
        t0 = origin.t0
    else:
        t0 = phys(t_ds[0]) + offset
    # Half-tick guard: the float round-trip (raw -> seconds -> raw) can land
    # a hair ABOVE the true boundary timestamp and silently drop head
    # events; over-inclusive bounds are safe because _finalize crops
    # exactly.
    eps = 0.5 if integer_us else 1e-9
    raw_lo = (max(t_start, 0.0) + t0 - offset - shift) / scale - eps
    raw_hi = (t_stop + t0 - offset - shift) / scale
    if t_stop >= 1e18:
        raw_hi = np.inf

    lo, hi = 0, n
    ms2idx = f["ms_to_idx"] if "ms_to_idx" in f else (
        g["ms_to_idx"] if "ms_to_idx" in g else None)
    if ms2idx is not None and integer_us and np.isfinite(raw_hi):
        m = int(ms2idx.shape[0])
        # ms_to_idx is indexed by raw stored time in ms (DSEC convention).
        ms_lo = int(np.clip(raw_lo // 1000, 0, m - 1))
        ms_hi = int(raw_hi // 1000 + 1)
        lo = int(ms2idx[ms_lo])
        hi = int(ms2idx[ms_hi]) if ms_hi < m else n
        # the table is coarse (1 ms): exact crop happens in _finalize
        return lo, min(hi, n), t0, scale
    if raw_lo > -np.inf:
        lo = _h5_bisect(t_ds, raw_lo, 0, n)
    if np.isfinite(raw_hi):
        hi = _h5_bisect(t_ds, raw_hi + 1.0 * (1.0 if integer_us else 1e-9),
                        lo, n)
    return lo, hi, t0, scale


def read_events_h5(
    path: str,
    t_start: float = 0.0,
    t_stop: float = 1e19,
    offset: float = 0.0,
    origin: Optional[TimeOrigin] = None,
    group: str = "events",
) -> Events:
    """DSEC / TUM-VIE HDF5 events: datasets {x, y, t, p} under `group`
    (or at the file root), with optional `t_offset` (µs) and `ms_to_idx`.

    Reads are WINDOWED: only the [t_start, t_stop] index range is loaded
    (ms_to_idx lookup or O(log E) bisection on the t column), so hour-scale
    DSEC files (1e9+ events) cost O(window) memory per chunk instead of a
    full-file materialization.

    Timestamps stored as integer microseconds are converted to float seconds.
    DSEC files are blosc-compressed; reading them needs `hdf5plugin`, which is
    surfaced as a clear error when absent.
    """
    import h5py

    try:
        import hdf5plugin  # noqa: F401  (registers codecs on import)
    except ImportError:
        pass

    with h5py.File(path, "r") as f:
        g = f[group] if group in f else f
        t_offset = float(f["t_offset"][()]) if "t_offset" in f else 0.0
        try:
            lo, hi, _, _ = _h5_window(g, f, t_start, t_stop, offset, origin)
            t = np.asarray(g["t"][lo:hi])
        except OSError as e:  # pragma: no cover - depends on codec presence
            raise OSError(
                f"cannot decode {path}: DSEC event files are blosc-compressed "
                "and need the hdf5plugin package"
            ) from e
        x = np.asarray(g["x"][lo:hi])
        y = np.asarray(g["y"][lo:hi])
        p = np.asarray(g["p"][lo:hi]) if "p" in g else None
        if lo > 0 and origin is not None and origin.t0 is None:
            # The window skipped the stream head; the run origin is still
            # the FILE's first timestamp (data_loading.cpp:30-31 semantics).
            t0_raw = np.asarray(g["t"][0:1])
            if np.issubdtype(t0_raw.dtype, np.integer):
                origin.t0 = float((t0_raw[0] + t_offset) * 1e-6 + offset)
            else:
                origin.t0 = float(t0_raw[0] + offset)
    if np.issubdtype(t.dtype, np.integer):
        t = (t.astype(np.float64) + t_offset) * 1e-6
    return _finalize(x, y, t, p, offset, t_start, t_stop, origin)


class H5EventSource:
    """Chunked column reader over an HDF5 event file — the bounded-memory
    feeder for streaming store ingest (io/evstore.write_store_streaming).

    Exposes the FULL file (windows are served later from the store's mmap
    index); reads touch O(chunk) elements per call.  Timestamps come back
    as absolute float64 seconds (integer-µs files are converted with their
    `t_offset`).  The file must be time-sorted (DSEC/TUM-VIE files are).
    """

    def __init__(self, path: str, group: str = "events"):
        import h5py

        try:
            import hdf5plugin  # noqa: F401
        except ImportError:
            pass
        self._f = h5py.File(path, "r")
        self._g = self._f[group] if group in self._f else self._f
        self.path = path
        t_ds = self._g["t"]
        self.count = int(t_ds.shape[0])
        self._integer_us = np.issubdtype(t_ds.dtype, np.integer)
        t_off = float(self._f["t_offset"][()]) if "t_offset" in self._f else 0.0
        self._scale = 1e-6 if self._integer_us else 1.0
        self._shift = t_off * 1e-6 if self._integer_us else 0.0

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def time_at(self, i: int) -> float:
        return float(self._g["t"][i]) * self._scale + self._shift

    def read(self, lo: int, hi: int, cols: str = "xytp"):
        """Columns of [lo, hi); unrequested columns come back None."""
        g = self._g
        x = np.asarray(g["x"][lo:hi]) if "x" in cols else None
        y = np.asarray(g["y"][lo:hi]) if "y" in cols else None
        t = None
        if "t" in cols:
            t = np.asarray(g["t"][lo:hi]).astype(np.float64)
            t = t * self._scale + self._shift
        p = np.asarray(g["p"][lo:hi]) if ("p" in cols and "p" in g) else None
        return x, y, t, p


def read_events_npz(
    path: str,
    t_start: float = 0.0,
    t_stop: float = 1e19,
    offset: float = 0.0,
    origin: Optional[TimeOrigin] = None,
) -> Events:
    """npz with arrays x, y, t, p — the framework's native fixture format.
    Integer t is microseconds; float t is seconds."""
    data = np.load(path)
    t = np.asarray(data["t"])
    if np.issubdtype(t.dtype, np.integer):
        t = t.astype(np.float64) * 1e-6
    p = data["p"] if "p" in data else None
    return _finalize(np.asarray(data["x"]), np.asarray(data["y"]), t, p,
                     offset, t_start, t_stop, origin)


def read_events_txt(
    path: str,
    t_start: float = 0.0,
    t_stop: float = 1e19,
    offset: float = 0.0,
    origin: Optional[TimeOrigin] = None,
) -> Events:
    """Plain text events `t x y p` per line (rpg / ECCV18 distribution
    format), t in seconds."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None, :]
    t, x, y = data[:, 0], data[:, 1], data[:, 2]
    p = data[:, 3] if data.shape[1] > 3 else None
    return _finalize(x, y, t, p, offset, t_start, t_stop, origin)


def read_events_rosbag(
    path: str,
    topic: str,
    t_start: float = 0.0,
    t_stop: float = 1e19,
    offset: float = 0.0,
    origin: Optional[TimeOrigin] = None,
) -> Events:
    """Every dvs_msgs/EventArray on `topic` of a ROS1 bag (parity with
    data_loading.cpp:221-302), through `io/rosbag1.py`."""
    from . import rosbag1

    x, y, t, p = rosbag1.read_event_bag(path, topic)
    return _finalize(x, y, t, p, offset, t_start, t_stop, origin)


READERS = {
    ".h5": read_events_h5,
    ".hdf5": read_events_h5,
    ".npz": read_events_npz,
    ".txt": read_events_txt,
    ".zip": read_events_txt,
}


def read_events(path: str, **kwargs) -> Events:
    """Dispatch on file extension; a bag needs its topic, through
    `read_events_rosbag`."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".bag":
        raise ValueError("use read_events_rosbag(path, topic=...) for bags")
    if ext not in READERS:
        raise ValueError(f"no event reader for extension {ext!r}")
    return READERS[ext](path, **kwargs)


def write_events_npz(path: str, ev: Events) -> None:
    arrays = dict(x=ev.x, y=ev.y, t=ev.t)
    if ev.p is not None:
        arrays["p"] = ev.p
    np.savez_compressed(path, **arrays)
