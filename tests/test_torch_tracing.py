"""The port's tracer (`dvs_mcemvs_torch.tracing`): off it costs one shared
no-op context; on, spans nest per thread under the names the port opens,
the programs' counters stay exact across threads, device time is exclusive
and idle time is put down to the main thread's spans, on the CPU pipelines
and through the CLI's --profile_dir trace.

The test marked `card` needs an NVIDIA GPU and skips without one; this file
imports no JAX, so on the card it runs as

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_tracing.py
"""

import bisect
import itertools
import json
import logging
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dvs_mcemvs_torch import cli as tcli, graphs, pipeline, tracing
from dvs_mcemvs_torch.kernels import binning
from dvs_mcemvs_torch.mapper import DsiShape, make_mapper
from dvs_mcemvs_torch.ops import se3, trajectory as trajmod
from dvs_mcemvs_torch.ops.se3 import SE3
from dvs_mcemvs_torch.utils import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET = os.path.join(REPO, "configs", "synthetic", "esim_stereo.conf")


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test leaves the tracer off."""
    yield
    tracing.disable()


def _rig(device, dim_z=16, n_samples=25):
    """Mappers, events (host arrays) and trajectories of the synthetic
    stereo rig over [0, 1] s."""
    rig = synthetic.esim_like_rig(travel=0.4)
    rng = np.random.default_rng(3)
    pts = synthetic.make_scene(rig, rng, 1200)
    events = [synthetic.simulate_events(rig, pts, i, n_samples=n_samples, rng=rng)
              for i in range(2)]
    ts, q, p = synthetic.rig_poses(rig)
    traj0 = trajmod.from_arrays(ts, q, p, device=device)
    T_1_0 = SE3(torch.tensor([1.0, 0.0, 0.0, 0.0], device=device),
                torch.tensor([-rig.baseline, 0.0, 0.0], device=device))
    trajs = [traj0, trajmod.apply_right(traj0, se3.inverse(T_1_0))]
    mapper = make_mapper(rig.cam, DsiShape(dim_z=dim_z, min_depth=1.0, max_depth=4.0))
    return [mapper, mapper], events, trajs


def _rows(snap, name):
    return [r for r in snap["spans"] if r[0] == name]


def test_off_is_one_shared_noop_and_records_nothing():
    tracing.enable()
    tracing.disable()
    a = tracing.span("process")
    assert a is tracing.span("replay.vote", torch.device("cpu")) is tracing.span("x")
    with a as inner:
        assert inner is a
    with tracing.timed("capture.vote") as sp:
        time.sleep(0.001)
    assert sp.seconds >= 0.001
    assert tracing.take_device_ms() == {}
    snap = tracing.snapshot()
    assert snap["spans"] == [] and snap["chunks"] == 0 and snap["by_name"] == {}


def test_spans_nest_per_thread():
    tracing.enable()
    ready, done = threading.Event(), threading.Event()

    def worker():
        with tracing.span("replay.extract"):
            ready.set()
            with tracing.span("wait.faults"):
                done.wait(10)

    t = threading.Thread(target=worker, name="save-0")
    with tracing.span("process"):
        t.start()
        assert ready.wait(10)
        with tracing.span("vote.stage"):
            with tracing.span("wait.staging"):
                pass
        with tracing.timed("capture.fusion"):
            pass
        done.set()
    t.join(10)
    assert not t.is_alive()
    tracing.disable()
    snap = tracing.snapshot()
    got = {(name, thread, depth) for name, thread, depth, *_ in snap["spans"]}
    assert got == {("process", 0, 0), ("vote.stage", 0, 1), ("wait.staging", 0, 2),
                   ("capture.fusion", 0, 1), ("replay.extract", 1, 0), ("wait.faults", 1, 1)}
    assert snap["threads"][1] == "save-0" and snap["chunks"] == 1
    by = {r[0]: r for r in snap["spans"]}
    for outer, inner in (("process", "vote.stage"), ("vote.stage", "wait.staging"),
                         ("replay.extract", "wait.faults")):
        assert by[outer][3] <= by[inner][3] <= by[inner][4] <= by[outer][4]
    assert all(r[5] is None and r[7] is None for r in snap["spans"])
    assert snap["counters"]["waits"] == 2
    assert snap["by_name"]["process"]["host_ms"] >= snap["by_name"]["vote.stage"]["host_ms"]


def test_counters_are_exact_across_threads():
    """4 threads x 10,000 updates of each counter: kernel launches, program
    evictions, staged events and pad, camera-chunks by DMA and by the fill,
    host arrays page-locked and their bytes, and launches held by a
    capture, which never reach the wrappers' counts."""
    n, threads = 10_000, 4
    cache = graphs.ProgramCache(1)

    class Prog:
        def close(self):
            pass

    def work():
        for i in range(n):
            tracing.launched(binning.bin_events)
            cache.put(i, Prog())
            tracing.staged(1, 2, ("dma", "fill")[i % 2])
            tracing.registered(4096)
        with tracing.held_launches() as held:
            for _ in range(n):
                tracing.launched(binning.bin_events)
        assert held == {binning.bin_events: n}

    tracing.enable()
    prev = sys.getswitchinterval()
    counts = binning.bin_events.launches, graphs.ProgramCache.evictions_total
    staged = dict(tracing.STAGED)
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(120)
        assert not any(t.is_alive() for t in pool)
        snap = tracing.snapshot()
    finally:
        sys.setswitchinterval(prev)
        binning.bin_events.launches, graphs.ProgramCache.evictions_total = counts
        tracing.STAGED.update(staged)
    assert snap["counters"]["launches"]["bin_events"] == threads * n
    assert snap["counters"]["staged"] == {
        "events": threads * n, "pad": 2 * threads * n, "dma_chunks": threads * n // 2,
        "fill_chunks": threads * n // 2, "registrations": threads * n,
        "locked_bytes": 4096 * threads * n}
    assert snap["counters"]["evictions"] == threads * (n - 1)
    assert snap["counters"]["captures"] == snap["counters"]["replays"] == 0


@pytest.mark.parametrize("pad,n,want_pad", [
    ("bucket", 3 * 256 + 5, 4 * 256 - (3 * 256 + 5)),   # off a bucket edge: padded
    ("bucket", 4 * 256, 0),                             # on a bucket edge
    ("bucket", 5 * 256 + 1, 8 * 256 - (5 * 256 + 1)),
    ("none", 3 * 256 + 5, 0),                           # no pad: the count as it is
])
def test_staged_counts_the_events_and_the_bucket_pad(pad, n, want_pad):
    """On the CPU's eager path each camera-chunk counts its events and the
    bucket pad's zero-weight events once, and one camera-chunk staged by the
    host fill, in the snapshot and the summary line."""
    from dvs_mcemvs_torch import mapper

    mappers, events, trajs = _rig("cpu")
    ev = events[0].slice(0, n)
    assert ev.num == n
    tracing.enable("cpu")
    for i in range(1, 3):
        dsi = mapper.evaluate_dsi(mappers[0], ev, trajs[0], se3.identity(device="cpu"),
                                  packet_size=256, pad=pad)
        assert dsi is not None
        assert tracing.snapshot()["counters"]["staged"] == dict(
            events=i * n, pad=i * want_pad, dma_chunks=0, fill_chunks=i, registrations=0,
            locked_bytes=0)
    tracing.disable()
    snap = tracing.snapshot()
    assert snap["counters"]["staged"] == dict(events=2 * n, pad=2 * want_pad, dma_chunks=0,
                                              fill_chunks=2, registrations=0, locked_bytes=0)
    share = 100.0 * want_pad / (n + want_pad)
    assert tracing.pad_share(snap["counters"]["staged"]) == pytest.approx(share)
    assert (f"; pad {share:.1f} % of the staged events; camera-chunks staged by DMA 0, by "
            "the host fill 2; host arrays page-locked 0 (0.0 MB); counters "
            in tracing.summary(snap))


def test_staging_counters_reset_at_enable_and_read_in_the_summary():
    """The staging's counters (camera-chunks by DMA and by the host fill,
    host arrays page-locked and their bytes) report what they gained since
    `enable()`, and the summary line reads them."""
    saved = dict(tracing.STAGED)
    try:
        tracing.staged(5, 3, "dma")
        tracing.staged(5, 3, "fill")
        tracing.registered(1 << 20)
        tracing.enable()
        assert set(tracing.snapshot()["counters"]["staged"].values()) == {0}
        for path in ("dma", "dma", "fill"):
            tracing.staged(10, 6, path)
        tracing.registered(4096)
        tracing.registered(2_500_000 - 4096)
        tracing.staged(4, 0)
        tracing.disable()
        snap = tracing.snapshot()
    finally:
        tracing.STAGED.update(saved)
    assert snap["counters"]["staged"] == dict(events=34, pad=18, dma_chunks=2, fill_chunks=1,
                                              registrations=2, locked_bytes=2_500_000)
    assert ("; camera-chunks staged by DMA 2, by the host fill 1; host arrays page-locked 2 "
            "(2.5 MB); counters " in tracing.summary(snap))


@pytest.mark.parametrize("intervals,want", [
    ([(0, 10), (2, 5)], [7, 3]),                     # nested: the outer keeps the rest
    ([(0, 6), (4, 10)], [4, 6]),                     # overlapping: the later start wins
    ([(0, 10), (2, 5), (3, 4)], [7, 2, 1]),          # nested twice
    ([(0, 4), (0, 4)], [0, 4]),                      # equal: the later recorded
    ([(0, 2), (5, 9)], [2, 4]),                      # disjoint
])
def test_exclusive_device_time(intervals, want):
    got = tracing.exclusive(intervals)
    assert got == want
    assert sum(got) == sum(e - s for s, e in tracing.merge(intervals))


def test_idle_arithmetic():
    """Device idle inside the process windows, each gap named by the
    innermost main-thread span open as it began."""
    windows = [(0, 100), (200, 260)]
    busy = [(10, 20), (15, 30), (50, 60), (150, 210), (240, 300)]
    spans = [("process", 0, 100, 0), ("vote.stage", 5, 40, 1), ("wait.staging", 25, 35, 2),
             ("replay.fusion", 40, 55, 1), ("process", 200, 260, 0)]
    got = tracing.idle_gaps(windows, busy, spans)
    assert got == [("process", 0, 10), ("wait.staging", 30, 50), ("process", 60, 100),
                   ("process", 210, 240)]
    assert sum(b - a for _, a, b in got) == (100 - 30) + (60 - 30)
    assert tracing.idle_gaps([(0, 10)], [], []) == [("none", 0, 10)]


@pytest.mark.parametrize("method", ["process_1", "process_2"])
def test_run_full_seq_records_a_process_and_a_window_per_chunk(method):
    """On the CPU: one `process` and one `full_seq.window` a chunk, the
    process spans the main thread's outermost, and no device interval."""
    mappers, events, trajs = _rig("cpu")
    fopts = pipeline.FullSeqOptions(start_time=0.0, stop_time=1.0, duration=0.5,
                                    out_skip=0.25)
    kw = dict(stereo_fusion=2, vopts=pipeline.VotingOptions(packet_size=256))
    if method == "process_2":
        kw.update(temporal_fusion=4, num_intervals=2)
    tracing.enable("cpu")
    out = list(pipeline.run_full_seq(mappers, events, trajs, fopts,
                                     getattr(pipeline, method), **kw))
    tracing.disable()
    snap = tracing.snapshot()
    assert len(out) == 3
    assert snap["chunks"] == len(_rows(snap, "process")) == len(out)
    assert len(_rows(snap, "full_seq.window")) == len(out)
    assert all(r[2] == 0 for r in _rows(snap, "process"))
    assert all(r[5] is None for r in snap["spans"])
    assert all(v["device_count"] == 0 for v in snap["by_name"].values())
    assert snap["process_idle_ms"] == pytest.approx(snap["by_name"]["process"]["host_ms"])


def test_clock_is_the_profilers():
    """The tracer's clock is the one torch.profiler stamps its host events
    with: a profiled range lies between two reads of it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    stamps = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            a = tracing.clock_ns()
            with record_function(f"probe{i}"):
                b = tracing.clock_ns()
                time.sleep(0.002)
                c = tracing.clock_ns()
            stamps.append((a, b, c, tracing.clock_ns()))
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for i, (a, b, c, d) in enumerate(stamps):
        e = events[f"probe{i}"]
        assert a <= e.start_ns() <= b and c <= e.end_ns() <= d


def test_cli_profile_dir_adds_the_spans(tmp_path, caplog):
    """--profile_dir on the CPU still writes trace.json, now with the
    tracer's spans as a process of their own, on the file's time base, and
    logs the tracer's summary."""
    data = tmp_path / "data"
    paths = synthetic.write_fixture(str(data), rig=synthetic.esim_like_rig(travel=0.4),
                                    n_pts=1200, n_samples=25)
    prof = tmp_path / "prof"
    argv = [f"--flagfile={PRESET}", f"--bag_filename_left={paths['events0']}",
            f"--bag_filename_right={paths['events1']}",
            f"--bag_filename_pose={paths['poses']}", f"--out_path={tmp_path / 'out'}/",
            "--dimZ=16", "--packet_size=256", "--platform=cpu", "--splat_backend=scatter",
            "--full_seq", "--start_time_s=0", "--stop_time_s=1", "--duration=0.5",
            "--out_skip=0.4", "--nosave_pointcloud", "--save_workers=2", "--nocheckpoint",
            "--nouse_event_store", f"--profile_dir={prof}"]
    with caplog.at_level(logging.INFO, logger="dvs_mcemvs_torch"):
        assert tcli.main(argv) == 0
    assert tracing.span("x") is tracing.span("y")
    assert "tracer: 2 chunks; a chunk, device ms: ; host ms: full_seq.window" in caplog.text
    trace = json.load(open(prof / "trace.json"))
    ours = [e for e in trace["traceEvents"] if e.get("pid") == tracing.TRACE_PID]
    names = [e["name"] for e in ours if e["ph"] == "X"]
    assert names.count("process") == 2 and names.count("full_seq.window") == 2
    # Each process span holds operations that the profiler recorded in it.
    theirs = [e["ts"] for e in trace["traceEvents"]
              if e.get("ph") == "X" and e.get("pid") != tracing.TRACE_PID]
    for e in ours:
        if e["ph"] == "X" and e["name"] == "process":
            assert any(e["ts"] <= t <= e["ts"] + e["dur"] for t in theirs)


# Clock cycles of the spin queued before every other chunk of the card
# test, ~20 ms at the H100's top SM clock: over twice what the host takes
# under the profiler to launch a chunk's programs (an ~8 ms spin sometimes
# ended before the second vote's launch).  The host wakes later from such
# long waits; the chunks between, with short waits, hold the least wake.
BUSY_CYCLES = 40_000_000


@pytest.mark.card
def test_device_intervals_share_the_host_clock():
    """On the card, two passes of process_1 waiting for the device after
    each chunk's votes (`wait.sync`), under the profiler:

    - the host clock: the last vote of a chunk ends no later than its
      `wait.sync` span, and, of the chunks where the card was still busy as
      the wait began, at least one within 50 us before the span's end (the
      host wakes some microseconds after the card is done, so a mapping
      late by any amount or early by 50 us fails);
    - the profile: each `replay.vote` interval of the second pass ends
      within 50 us of the last operation its span launched (its output
      copy), and starts within 50 us of where its work could start: the
      end of the card's operation before the graph's first kernel, or, on
      a card already idle, the host's call that launched the graph (the
      event runs as it is queued, and under the profiler that call takes
      milliseconds before the graph's first kernel).  Where the card was
      still busy as the call that queued the vote's first operation (a copy
      of its events, or the graph) returned, that is also within 50 us of
      that operation, which holds for both votes of every other chunk: a
      spin of the card queued before those chunks (`BUSY_CYCLES`) keeps it
      busy while the host launches the chunk's programs.  A card that frees
      up while that call runs (under the profiler a copy's call can take a
      millisecond) starts the operation only as the call returns, so such a
      vote is held to its start alone.  The chunks between start on an idle
      card, or one that frees up within a few hundred microseconds, so both
      kinds of start are checked.  The profiler's
      device stamps drift
      against its own host stamps, by an amount that differs from one
      profile to the next, so a line fitted to the end offsets is taken off
      them; the offsets and the drift are printed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dvs_mcemvs_torch import mapper

    dev = torch.device("cuda", 0)
    mappers, events, trajs = _rig(dev, dim_z=100, n_samples=200)
    fopts = pipeline.FullSeqOptions(start_time=0.0, stop_time=1.0, duration=0.5,
                                    out_skip=0.1)
    kw = dict(stereo_fusion=2, vopts=pipeline.VotingOptions(packet_size=1024, sync=True))

    def busy_every_other():
        """process_1 with the spin queued before its first, third, ... call."""
        calls = itertools.count()

        def process(*args, **kwargs):
            if next(calls) % 2 == 0:
                torch.cuda._sleep(BUSY_CYCLES)
            return pipeline.process_1(*args, **kwargs)
        return process

    try:
        for _ in pipeline.run_full_seq(mappers, events, trajs, fopts, busy_every_other(),
                                       **kw):
            pass
        torch.cuda.synchronize(dev)
        tracing.enable(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                n = sum(1 for _ in pipeline.run_full_seq(mappers, events, trajs, fopts,
                                                         busy_every_other(), **kw))
            torch.cuda.synchronize(dev)
        tracing.disable()
        snap = tracing.snapshot()
    finally:
        pipeline.clear_programs()
        mapper.clear_programs()
    votes = _rows(snap, "replay.vote")
    syncs = _rows(snap, "wait.sync")
    assert len(votes) == 2 * len(syncs) == 2 * 2 * n and snap["counters"]["captures"] == 0
    tol = 50_000
    wake = []
    for (*_, d1, _), (_, _, _, start, end, *_) in zip(votes[1::2], syncs):
        assert d1 <= end, (d1, end)
        if d1 >= start:
            wake.append(end - d1)

    kineto = list(prof.profiler.kineto_results.events())
    ops = {}
    for e in kineto:
        if e.device_type() == DeviceType.CUDA:
            ops.setdefault(e.correlation_id(), []).append((e.start_ns(), e.end_ns()))
    calls = [(e.start_ns(), e.end_ns(), e.correlation_id()) for e in kineto
             if e.device_type() == DeviceType.CPU and e.name().startswith("cu")
             and e.correlation_id() in ops]
    assert calls, "the profile links no launch to a device operation"
    every = sorted(x for v in ops.values() for x in v)
    reach = np.maximum.accumulate([e for _, e in every])   # latest end so far
    t, first, last, before, launch, queued, d0s = [], [], [], [], [], [], []
    for _, _, _, start, end, d0, d1, _ in votes[2 * n:]:
        mine = sorted((c0, c1, x) for c0, c1, c in calls if start <= c0 <= end
                      for x in ops[c])
        assert mine, f"no operation launched in [{start}, {end}]"
        k = bisect.bisect_left(every, mine[0][2]) - 1
        t.append((d1 - votes[2 * n][6]) / 1e9)
        first.append(mine[0][2][0])
        last.append(max(e for _, _, (_, e) in mine) - d1)
        before.append(reach[k] if k >= 0 else -np.inf)
        launch.append(mine[0][0])
        queued.append(mine[0][1])
        d0s.append(d0)
    slope, offset = np.polyfit(t, last, 1)
    drift = slope * np.asarray(t) + offset
    ends = np.asarray(last) - drift
    first, before = np.asarray(first) - drift, np.asarray(before) - drift
    busy = before > np.asarray(launch)
    # Still busy as the call that queued the first operation returned.
    held = before > np.asarray(queued)
    starts = np.asarray(d0s) - np.where(busy, before, launch)
    print(json.dumps({"sync_end_minus_vote_end_us": [round(w / 1e3, 1) for w in wake],
                      "start_end_offsets_us": [[round(a / 1e3, 1), round(b / 1e3, 1)]
                                               for a, b in zip(starts, ends)],
                      "card_busy": busy.tolist(),
                      "busy_past_launch_us": [round(x / 1e3, 1) if np.isfinite(x) else None
                                              for x in before - np.asarray(launch)],
                      "busy_past_queued_us": [round(x / 1e3, 1) if np.isfinite(x) else None
                                              for x in before - np.asarray(queued)],
                      "first_kernel_minus_start_us": [round(x / 1e3, 1)
                                                      for x in first - np.asarray(d0s)],
                      "profile_drift_ppm": slope / 1e3,
                      "device": torch.cuda.get_device_name(0), "torch": torch.__version__}))
    assert len(wake) >= n and min(wake) <= tol, wake
    assert np.all(np.abs(starts) <= tol) and np.all(np.abs(ends) <= tol), (starts, ends)
    assert busy.sum() >= n and (~busy).sum() >= 1, busy
    assert held.sum() >= n, held
    assert np.all(np.abs(first - np.asarray(d0s))[held] <= tol), first - np.asarray(d0s)


def test_vote_counters_read_in_the_snapshot_and_the_summary():
    """The vote pass's counters (a device buffer a device; here a CPU
    stand-in) report what they gained since `enable()`, in the snapshot and
    in the summary line as visits a hit and fallbacks."""
    from dvs_mcemvs_torch.kernels import scatter

    dev = torch.device("cpu")
    saved = dict(scatter._COUNTS)
    buf = scatter._COUNTS[dev] = torch.tensor([100, 40, 1])
    try:
        tracing.enable()
        buf += torch.tensor([600, 240, 2])
        tracing.disable()
        snap = tracing.snapshot()
    finally:
        scatter._COUNTS.clear()
        scatter._COUNTS.update(saved)
    assert snap["counters"]["scatter_vote"] == dict(visits=600, hits=240, fallbacks=2)
    assert "; vote visits a hit 2.500, fallbacks 2; pad " in tracing.summary(snap)
    assert '"scatter_vote": {"visits": 600, "hits": 240, "fallbacks": 2}' in tracing.summary(snap)
