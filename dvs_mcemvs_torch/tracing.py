"""The port's tracer: host spans, each program's device time from CUDA
events, host waits and the programs' counters, on the clock of
torch.profiler's host events.

Off by default, and then `span(name)` returns one shared no-op context: no
allocation, no clock read, no CUDA call.  `enable(device)` turns it on for
the process and anchors the device's event clock to the host clock with one
synchronised event; `disable()` turns it off; `snapshot()` re-anchors,
resolves every device interval and sums up the session.

Spans (nested per thread):

  full_seq.window   `pipeline.run_full_seq(_stores)`: a chunk's slicing
  process           `pipeline.process_1`, `process_time_fusion`, whole
  vote.stage        `mapper.Program._load`, `sharded.StepProgram._load`:
                    a vote's inputs staged to the card                    [device]
  wait.staging      `graphs.Staging.load` waiting for a pinned set
  replay.<kind>     a program's call: its input copies, the graph's
                    replay and its output copy                            [device]
  capture.<kind>    a program's first call: the eager warm-up and the
                    capture (`capture_s` is this span's length)
  wait.faults       `graphs.check_faults` reading the fault flags
  wait.sync         `pipeline._synchronize` waiting for the device

Kinds: vote, reference_view, fusion, temporal, extract, sharded.

The clock is `time.time_ns()` (CLOCK_REALTIME on Linux), the clock that c10
converts the profiler's host stamps to: a span's start minus a profile's
`trace_start_ns` places it on that profile's timeline.

A span marked [device], given a CUDA device that `enable` anchored, records
a pair of timing events on the current stream that covers the work the
span queued: the first at the span's first `mark()`, just before its
device work is queued (`graphs.Staging.load` once the pinned buffers are
filled; `graphs.Graph.replay`, `graphs.Captured` and the vote's
device-to-device and DMA stagings before they queue anything), so that
host work before it (a fill, on an idle stream) stays out of the interval,
though on an idle stream the interval still holds the launch call itself
(tens of microseconds; milliseconds under torch.profiler); the second as
the span closes.  A span never marked has no interval.  Threads
that share a stream (the save workers share the legacy default stream
with the main thread) can queue traced work inside another thread's pair,
so each span's device time is reported exclusive of the traced intervals
that start inside it.  A pair is resolved once it has completed, by
`query()` every `RESOLVE_EVERY` closed pairs, at `take_device_ms()` or at
`snapshot()`: the tracer waits for the device only at the anchors.

Counters: `graphs.Graph.captures_total` and `replays_total`, the launches
of `graphs.COUNTED`'s kernel wrappers,
`graphs.ProgramCache.evictions_total` and `STAGED` (the vote's staged
events: the chunk's own and the bucket pad's zero-weight ones, counted by
`staged` once a camera-chunk; the camera-chunks staged by DMA and by the
host fill; the host arrays page-locked and their bytes, by `registered`),
each updated under `COUNTS` (exact across threads); `snapshot()` reports
what they gained since `enable()`.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import heapq
import itertools
import json
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

clock_ns = time.time_ns

# Guards every counter of the programs: the graphs' captures and replays,
# the program caches' evictions and the counted kernel wrappers' launches.
COUNTS = threading.Lock()
_held = threading.local()


# The vote's staging (`mapper._stage`, `_stage_dma`, `_stage_device`):
# "events", the chunk's own; "pad", the zero-weight events of the bucket
# pad past them; "dma_chunks", the camera-chunks copied by DMA from host
# arrays page-locked in place (`_stage_dma`); "fill_chunks", those written
# into pinned or pageable buffers on the host first (`_stage`);
# "registrations" and "locked_bytes", the host arrays page-locked
# (`graphs.PageLocks`) and the bytes of their pages.
STAGED = {"events": 0, "pad": 0, "dma_chunks": 0, "fill_chunks": 0, "registrations": 0,
          "locked_bytes": 0}


def staged(events: int, pad: int, path: Optional[str] = None) -> None:
    """Count one staging of `events` events and `pad` pad events, and the
    camera-chunk under `path` ("dma" or "fill") if given."""
    with COUNTS:
        STAGED["events"] += events
        STAGED["pad"] += pad
        if path is not None:
            STAGED[path + "_chunks"] += 1


def registered(nbytes: int) -> None:
    """Count a host array page-locked over `nbytes` bytes."""
    with COUNTS:
        STAGED["registrations"] += 1
        STAGED["locked_bytes"] += nbytes


def launched(fn) -> None:
    """Count a launch of the kernel wrapper `fn` (`fn.launches`), or, on a
    thread inside `held_launches()`, into that tally instead."""
    tally = getattr(_held, "tally", None)
    if tally is not None:
        tally[fn] = tally.get(fn, 0) + 1
        return
    with COUNTS:
        fn.launches += 1


@contextlib.contextmanager
def held_launches() -> Iterator[dict]:
    """Inside, this thread's launches go to the dict yielded ({wrapper:
    count}) and not to the wrappers' counts: a capture records launches
    that launch nothing until a replay."""
    prev = getattr(_held, "tally", None)
    _held.tally = tally = {}
    try:
        yield tally
    finally:
        _held.tally = prev


def _counters() -> dict:
    from . import graphs

    with COUNTS:
        return {"captures": graphs.Graph.captures_total,
                "replays": graphs.Graph.replays_total,
                "evictions": graphs.ProgramCache.evictions_total,
                "launches": {f.__name__: f.launches for f in graphs.COUNTED},
                "staged": dict(STAGED)}


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

_on = False
_session: Optional["_Session"] = None
_stacks = threading.local()
_seq = itertools.count()
# The pairs closed between two looks for completed ones.
RESOLVE_EVERY = 64
# The main thread's spans inside which the device's idle time is counted.
IDLE_WINDOW = "process"


class _Null:
    """The span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("name", "device", "session", "seq", "tid", "depth", "start", "end",
                 "stream", "events", "dev")

    def __init__(self, name: str, device: Optional[torch.device],
                 session: Optional["_Session"]):
        self.name, self.device, self.session = name, device, session
        self.stream = self.events = self.dev = None

    def __enter__(self) -> "_Span":
        stack = getattr(_stacks, "spans", None)
        if stack is None:
            stack = _stacks.spans = []
        self.depth = len(stack)
        stack.append(self)
        self.seq = next(_seq)
        self.tid = threading.get_ident()
        s = self.session
        if s is not None and self.device in s.anchors:
            self.stream = torch.cuda.current_stream(self.device)
        self.start = clock_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self.events is not None:
            self.events[1].record(self.stream)
        self.end = clock_ns()
        _stacks.spans.pop()
        if self.session is not None:
            self.session.add(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


def span(name: str, device: Optional[torch.device] = None):
    """A context that records a span of `name` on this thread while the
    tracer is on, with a device interval where `device` is a CUDA device
    that `enable` anchored; the shared no-op context while it is off."""
    if not _on:
        return _NULL
    return _Span(name, device, _session)


def mark() -> None:
    """This thread is about to queue device work: each of its open spans
    with a device interval that has not started yet records its first
    event now."""
    if not _on:
        return
    for sp in getattr(_stacks, "spans", ()):
        if sp.stream is not None and sp.events is None:
            sp.events = (sp.session.event(sp.device), sp.session.event(sp.device))
            sp.events[0].record(sp.stream)


def timed(name: str) -> _Span:
    """A span that measures its own length (`.seconds`) whether or not the
    tracer is on, and is recorded only while it is on (a program's
    capture)."""
    return _Span(name, None, _session if _on else None)


def traced(name: str):
    """Decorator: the function's calls run inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name, None, _session):
                return fn(*args, **kwargs)

        return inner

    return wrap


def _anchor(device: torch.device) -> Tuple[torch.cuda.Event, int]:
    """An event recorded on the idle device and the host time it ran at."""
    torch.cuda.synchronize(device)
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    host = clock_ns()
    ev.synchronize()
    return ev, host


class _Session:
    """What one `enable()` records until the next."""

    def __init__(self, devices: Sequence[torch.device]):
        self.records: List[_Span] = []
        self.threads: Dict[int, str] = {}
        self.pending: List[_Span] = []
        self.resolve_at = RESOLVE_EVERY
        self.resolved: List[_Span] = []
        self.taken = 0
        self.lock = threading.Lock()
        self.free: Dict[torch.device, List[torch.cuda.Event]] = {d: [] for d in devices}
        self.anchors = {d: _anchor(d) for d in devices}
        self.scale = {d: 1.0 for d in devices}
        self.base = _counters()

    def event(self, device: torch.device) -> torch.cuda.Event:
        free = self.free[device]
        try:
            return free.pop()
        except IndexError:
            return torch.cuda.Event(enable_timing=True)

    def add(self, sp: _Span) -> None:
        if sp.tid not in self.threads:
            self.threads[sp.tid] = threading.current_thread().name
        self.records.append(sp)
        if sp.events is not None:
            with self.lock:
                self.pending.append(sp)
                look = len(self.pending) >= self.resolve_at
            if look:
                self.resolve()

    def resolve(self, final: bool = False) -> None:
        """Read the device intervals (ms after the anchor) of the pairs that
        have completed (every pair, when `final`: after an anchor's sync)."""
        with self.lock:
            keep = []
            for sp in self.pending:
                e0, e1 = sp.events
                if not (final or e1.query()):
                    keep.append(sp)
                    continue
                t0 = self.anchors[sp.device][0].elapsed_time(e0)
                sp.dev = (t0, t0 + e0.elapsed_time(e1))
                sp.events = None
                self.free[sp.device].extend((e0, e1))
                self.resolved.append(sp)
            self.pending = keep
            self.resolve_at = len(keep) + RESOLVE_EVERY

    def reanchor(self) -> None:
        """Fit the device clock's rate to the host clock's between the
        enabling anchor and a new one."""
        for d, (ev, host) in self.anchors.items():
            ev1, host1 = _anchor(d)
            ms = ev.elapsed_time(ev1)
            self.scale[d] = (host1 - host) / (ms * 1e6) if ms > 0 else 1.0

    def device_ns(self, sp: _Span) -> Tuple[int, int]:
        host, scale = self.anchors[sp.device][1], self.scale[sp.device]
        return tuple(host + int(round(t * 1e6 * scale)) for t in sp.dev)


def _device(device) -> Optional[torch.device]:
    if device is None:
        return None
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def enable(device=None) -> None:
    """Start a session and turn the tracer on; `device`, a CUDA device, has
    its event clock anchored (one synchronisation), so that spans on it
    record device intervals."""
    global _on, _session
    dev = _device(device)
    _session = _Session([dev] if dev is not None else [])
    _on = True


def disable() -> None:
    global _on
    _on = False


def take_device_ms() -> Dict[str, float]:
    """Device ms by span name of the intervals that completed since the
    last call (each exclusive of the others'), for a per-chunk log line;
    {} while the tracer is off."""
    s = _session
    if not _on or s is None:
        return {}
    s.resolve()
    with s.lock:
        new = s.resolved[s.taken:]
        s.taken = len(s.resolved)
    new.sort(key=lambda sp: sp.seq)
    out: Dict[str, float] = {}
    for sp, ms in zip(new, exclusive([sp.dev for sp in new])):
        out[sp.name] = out.get(sp.name, 0.0) + ms
    return out


def pad_share(staged: Dict[str, int]) -> float:
    """The bucket pad's share of the events staged, in %."""
    total = staged["events"] + staged["pad"]
    return 100.0 * staged["pad"] / total if total else 0.0


# ---------------------------------------------------------------------------
# The arithmetic of a session
# ---------------------------------------------------------------------------


def exclusive(intervals: Sequence[Tuple[float, float]]) -> List[float]:
    """Each interval's length not covered by the intervals that start
    inside it: every moment goes to the covering interval that started
    last (at equal starts, the later in `intervals`), so the lengths sum to
    the union's."""
    out = [0.0] * len(intervals)
    points = sorted([(s, 1, i) for i, (s, _) in enumerate(intervals)]
                    + [(e, 0, i) for i, (_, e) in enumerate(intervals)])
    heap: List[Tuple[float, int, int]] = []   # the open intervals, latest first
    done = [False] * len(intervals)
    prev = None
    for t, opens, i in points:
        while heap and done[heap[0][2]]:
            heapq.heappop(heap)
        if heap:
            out[heap[0][2]] += t - prev
        prev = t
        if opens:
            heapq.heappush(heap, (-intervals[i][0], -i, i))
        else:
            done[i] = True
    return out


def merge(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of `intervals`, as disjoint intervals in order."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_gaps(windows: Sequence[Tuple[float, float]], busy: Sequence[Tuple[float, float]],
              spans: Sequence[Tuple[str, float, float, int]]) -> List[Tuple[str, float, float]]:
    """The stretches of `windows` (the main thread's `process` spans) in
    which no interval of `busy` (device intervals, any thread) runs, as
    (name, start, end): each named by the innermost of `spans` (name,
    start, end, depth: the main thread's spans) open when it began."""
    merged = merge(busy)
    ends = [e for _, e in merged]
    spans = sorted(spans, key=lambda x: (x[1], x[3]))
    starts = [x[1] for x in spans]

    def name_at(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:
            name, s, e, _ = spans[i]
            if s <= t < e:
                return name
            i -= 1
        return "none"

    gaps = []
    for a, b in windows:
        cur = a
        i = bisect.bisect_right(ends, a)
        while i < len(merged) and merged[i][0] < b:
            s, e = merged[i]
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
            i += 1
        if cur < b:
            gaps.append((cur, b))
    return [(name_at(s), s, e) for s, e in gaps]


TOP_GAPS = 10


def snapshot() -> Optional[dict]:
    """The last session, summed up: the device re-anchored and every pair
    resolved (call it once the caller's work has drained).  ms throughout;
    `chunks` counts the main thread's `process` spans.

    {"chunks",
     "by_name": {name: {"count", "host_ms", "device_count",
                        "device_ms" (exclusive)}},
     "counters": {"captures", "replays", "evictions", "launches": {wrapper: n},
                  "staged": {"events", "pad", "dma_chunks", "fill_chunks",
                             "registrations", "locked_bytes"}, "waits", "wait_ms"},
     "process_idle_ms", "idle_by_span": {name: ms}, "gaps": [[name, ms]] (the
     longest), "threads": [name], "spans": [[name, thread, depth, start_ns,
     end_ns, device_start_ns, device_end_ns, device_exclusive_ms]]}
    None before the first `enable()`."""
    s = _session
    if s is None:
        return None
    s.reanchor()
    s.resolve(final=True)
    records = sorted(s.records, key=lambda sp: sp.seq)
    main = threading.main_thread().ident
    tids: Dict[int, int] = {main: 0}
    for sp in records:
        tids.setdefault(sp.tid, len(tids))
    dev = {id(sp): s.device_ns(sp) for sp in records if sp.dev is not None}
    devs = [sp for sp in records if sp.dev is not None]
    excl = dict(zip(map(id, devs), exclusive([dev[id(sp)] for sp in devs])))
    by_name: Dict[str, dict] = {}
    for sp in records:
        row = by_name.setdefault(sp.name, {"count": 0, "host_ms": 0.0,
                                           "device_count": 0, "device_ms": 0.0})
        row["count"] += 1
        row["host_ms"] += (sp.end - sp.start) / 1e6
        if id(sp) in excl:
            row["device_count"] += 1
            row["device_ms"] += excl[id(sp)] / 1e6
    now = _counters()
    counters = {k: now[k] - s.base[k] for k in ("captures", "replays", "evictions")}
    counters["launches"] = {k: v - s.base["launches"].get(k, 0)
                            for k, v in now["launches"].items()}
    counters["staged"] = {k: v - s.base["staged"][k] for k, v in now["staged"].items()}
    waits = [sp for sp in records if sp.name.startswith("wait.")]
    counters["waits"] = len(waits)
    counters["wait_ms"] = sum(sp.end - sp.start for sp in waits) / 1e6
    main_spans = [(sp.name, sp.start, sp.end, sp.depth) for sp in records if sp.tid == main]
    windows = [(sp.start, sp.end) for sp in records
               if sp.tid == main and sp.name == IDLE_WINDOW]
    gaps = idle_gaps(windows, list(dev.values()), main_spans)
    idle_by_span: Dict[str, float] = {}
    for name, a, b in gaps:
        idle_by_span[name] = idle_by_span.get(name, 0.0) + (b - a) / 1e6
    longest = sorted(gaps, key=lambda g: g[2] - g[1], reverse=True)[:TOP_GAPS]
    return {
        "chunks": len(windows),
        "by_name": by_name,
        "counters": counters,
        "process_idle_ms": sum(b - a for _, a, b in gaps) / 1e6,
        "idle_by_span": idle_by_span,
        "gaps": [[name, (b - a) / 1e6] for name, a, b in longest],
        "threads": [s.threads.get(t, threading.main_thread().name) for t in tids],
        "spans": [[sp.name, tids[sp.tid], sp.depth, sp.start, sp.end,
                   *(dev[id(sp)] if id(sp) in dev else (None, None)),
                   excl[id(sp)] / 1e6 if id(sp) in excl else None] for sp in records],
    }


def summary(snap: dict) -> str:
    """One line of `snap` a chunk (its `process` spans): each span's
    device ms (exclusive) and host ms, the device idle inside `process` by
    the span it fell in, the longest gaps, the bucket pad's share of the
    staged events, the camera-chunks staged by DMA and by the host fill,
    the host arrays page-locked, and the counters."""
    n = max(snap["chunks"], 1)
    staged = snap["counters"]["staged"]
    return (f"{snap['chunks']} chunks; a chunk, device ms: "
            + ", ".join(f"{k} {v['device_ms'] / n:.3f}" for k, v in snap["by_name"].items()
                        if v["device_count"])
            + "; host ms: "
            + ", ".join(f"{k} {v['host_ms'] / n:.3f}" for k, v in snap["by_name"].items())
            + f"; device idle in process {snap['process_idle_ms'] / n:.3f} ms ("
            + ", ".join(f"{k} {v / n:.3f}" for k, v in snap["idle_by_span"].items())
            + "); longest gaps, ms: "
            + ", ".join(f"{name} {ms:.3f}" for name, ms in snap["gaps"])
            + f"; pad {pad_share(staged):.1f} % of the staged events"
            + f"; camera-chunks staged by DMA {staged['dma_chunks']}, by the host fill "
            + f"{staged['fill_chunks']}; host arrays page-locked {staged['registrations']} "
            + f"({staged['locked_bytes'] / 1e6:.1f} MB)"
            + f"; counters {json.dumps(snap['counters'])}")


# The process id of the tracer's rows in a chrome trace.
TRACE_PID = 1 << 30


def add_to_chrome_trace(path: str, snap: dict) -> None:
    """Add `snap`'s spans and device intervals to the chrome trace at
    `path` (torch.profiler's `export_chrome_trace`), as a process of their
    own on that file's time base (`baseTimeNanoseconds`): a row per thread
    for its host spans, a row per thread for its device intervals."""
    with open(path) as f:
        data = json.load(f)
    base = int(data.get("baseTimeNanoseconds", 0))
    pid = TRACE_PID
    rows = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
             "args": {"name": "dvs_mcemvs_torch.tracing"}}]
    for i, name in enumerate(snap["threads"]):
        rows.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": 2 * i + 1,
                     "args": {"name": f"{name}: host spans"}})
        rows.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": 2 * i + 2,
                     "args": {"name": f"{name}: device intervals"}})
    for name, thread, _, start, end, d0, d1, excl in snap["spans"]:
        rows.append({"ph": "X", "cat": "host", "name": name, "pid": pid, "tid": 2 * thread + 1,
                     "ts": (start - base) / 1e3, "dur": (end - start) / 1e3})
        if d0 is not None:
            rows.append({"ph": "X", "cat": "device", "name": name, "pid": pid,
                         "tid": 2 * thread + 2, "ts": (d0 - base) / 1e3,
                         "dur": (d1 - d0) / 1e3, "args": {"exclusive_ms": excl}})
    data["traceEvents"].extend(rows)
    with open(path, "w") as f:
        json.dump(data, f)
