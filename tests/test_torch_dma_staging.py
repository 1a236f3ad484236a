"""The vote's staging by DMA (`mapper._stage_dma`, `graphs.PageLocks`): a
chunk sliced from host arrays that lie in page-locked memory is copied
straight into the program's static buffers, its time cast to float32 and
its bucket pad written on the device.

On the CPU, torch CPU tensors stand in for the card: the DMA staging
against the host fill (`mapper._stage`) bit for bit, and the page locks,
driven through a fake register/unregister pair, through a program's
staging (`mapper.Program._load`) over the passes of
`pipeline.run_full_seq`, which locks its streams, and of
`run_full_seq_stores`, which locks nothing.

The test marked `card` needs an NVIDIA GPU and skips without one; this file
imports no JAX, so on the card it runs as

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_dma_staging.py
"""

import gc

import numpy as np
import pytest
import torch

from dvs_mcemvs_torch import graphs, mapper, pipeline, tracing
from dvs_mcemvs_torch.mapper import DsiShape, Events, make_mapper
from dvs_mcemvs_torch.ops import se3, trajectory as trajmod
from dvs_mcemvs_torch.ops.camera import PinholeCamera
from dvs_mcemvs_torch.ops.se3 import SE3
from dvs_mcemvs_torch.utils import synthetic

PACKET = 256


@pytest.fixture(autouse=True)
def tracer_off():
    yield
    tracing.disable()


def _boundary_times(n: int, rng) -> np.ndarray:
    """n sorted float64 times, most at or next to the midpoint of two
    neighbouring float32 values (a tie, which rounds to the even one, and
    the float64 values on either side of it), the rest exactly float32 or
    anywhere."""
    lo = np.sort(rng.uniform(0.0, 2.0, n)).astype(np.float32)
    hi = np.nextafter(lo, np.float32(np.inf))
    mid = (lo.astype(np.float64) + hi.astype(np.float64)) / 2
    kind = rng.integers(0, 5, n)
    t = np.select([kind == 0, kind == 1, kind == 2, kind == 3],
                  [mid, np.nextafter(mid, -np.inf), np.nextafter(mid, np.inf),
                   lo.astype(np.float64)], rng.uniform(lo, hi))
    return np.sort(t)


def _stream(n: int, rng, width: int = 240, height: int = 180) -> Events:
    """A chunk of n events viewing a longer stream, as `Events.time_window`
    slices the run's arrays."""
    pad = 37
    x = rng.integers(0, width, n + 2 * pad).astype(np.int32)
    y = rng.integers(0, height, n + 2 * pad).astype(np.int32)
    t = np.concatenate([np.zeros(pad), _boundary_times(n, rng), np.full(pad, 3.0)])
    return Events(x, y, t).slice(pad, pad + n)


@pytest.mark.parametrize("pad,n", [
    ("bucket", 3 * PACKET + 5),      # a partial last packet, padded to the bucket
    ("bucket", 4 * PACKET),          # on a bucket edge: no pad
    ("bucket", 1),                   # one event, padded to a packet
    ("bucket", 5 * PACKET + 1),
    ("none", 3 * PACKET + 5),        # no pad: the chunk's own count
    ("none", 1),
])
def test_dma_staging_matches_the_fill_bit_for_bit(pad, n):
    """x, y, the float32 times and the weights staged by DMA (into buffers
    that held another chunk) equal the host fill's to the bit."""
    rng = np.random.default_rng(n)
    ev = _stream(n, rng)
    n_static = mapper._n_static(n, PACKET, pad)
    bucket = pad == "bucket"
    host = [np.empty(n_static, np.int32), np.empty(n_static, np.int32),
            np.empty(n_static, np.float32), np.empty(n_static, np.float32) if bucket else None]
    mapper._stage(ev, *host)
    dev = [torch.from_numpy(rng.integers(-9, 9, n_static).astype(np.int32)),
           torch.from_numpy(rng.integers(-9, 9, n_static).astype(np.int32)),
           torch.full((n_static,), np.nan, dtype=torch.float32),
           torch.full((n_static,), 7.0) if bucket else None]
    t64 = torch.full((n_static,), np.nan, dtype=torch.float64)
    mapper._stage_dma(ev, *dev, t64)
    for want, got in zip(host, dev):
        if want is None:
            assert got is None
            continue
        assert got.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert np.array_equal(host[2][:n], ev.t.astype(np.float32))


class _Fake:
    """A register/unregister pair that records its calls; `refuse` refuses
    every registration."""

    def __init__(self, refuse: bool = False):
        self.refuse = refuse
        self.registered, self.released = [], []

    def register(self, ptr: int, size: int) -> bool:
        self.registered.append((ptr, size))
        return not self.refuse

    def unregister(self, ptr: int, done) -> None:
        self.released.append(ptr)


class _CpuLocks(graphs.PageLocks):
    """Page locks for CPU buffers: no card reads the arrays, so no copies
    hold their release back."""

    def copied(self, device, *arrays):
        pass


@pytest.fixture
def fake(monkeypatch):
    """The process's page locks replaced by fresh ones on a fake pair, and
    the CPU taken for a device that runs programs (its tensors stand in
    for the card), so that `run_full_seq` locks its streams."""
    monkeypatch.setattr(graphs, "use_programs", lambda device: True)

    def make(refuse=False):
        f = _Fake(refuse)
        monkeypatch.setattr(graphs, "PAGE_LOCKS", _CpuLocks(f.register, f.unregister))
        return f

    return make


def _rig():
    """Mappers, events (host arrays, one owner each of x, y, t a camera),
    trajectories on the CPU and full_seq options of three chunks."""
    rig = synthetic.esim_like_rig(travel=0.4)
    rng = np.random.default_rng(3)
    pts = synthetic.make_scene(rig, rng, 1200)
    events = [synthetic.simulate_events(rig, pts, i, n_samples=25, rng=rng) for i in range(2)]
    ts, q, p = synthetic.rig_poses(rig)
    traj0 = trajmod.from_arrays(ts, q, p, device="cpu")
    T_1_0 = SE3(torch.tensor([1.0, 0.0, 0.0, 0.0]), torch.tensor([-rig.baseline, 0.0, 0.0]))
    trajs = [traj0, trajmod.apply_right(traj0, se3.inverse(T_1_0))]
    m = make_mapper(rig.cam, DsiShape(dim_z=8, min_depth=1.0, max_depth=4.0))
    fopts = pipeline.FullSeqOptions(start_time=0.0, stop_time=1.0, duration=0.5,
                                    out_skip=0.25)
    return [m, m], events, trajs, fopts


class _HostStaging:
    """A program's host fill straight into its CPU buffers (`graphs.Staging`
    stages through pinned sets into buffers on the card)."""

    def __init__(self, buffers):
        self.buffers = buffers

    def load(self, fill):
        fill([b.numpy() for b in self.buffers])


class _Store:
    """An event store's windows: fresh arrays a window, as
    `io.evstore.EventStore.window` decodes them."""

    def __init__(self, ev: Events):
        self.ev = ev

    def prefetch(self, t0, t1):
        pass

    def window(self, t0, t1) -> Events:
        ev = self.ev.time_window(t0, t1)
        return Events(ev.x.copy(), ev.y.copy(), ev.t.copy())


def _process_2(ev: Events, camera: int) -> list:
    return pipeline.split_subintervals(ev, 2)


def _process_5(ev: Events, camera: int) -> list:
    """process_5's split: the second camera's starts one sub-interval on
    and wraps around, one of its two sub-intervals a concatenation."""
    if camera == 0:
        return pipeline.split_subintervals(ev, 2)
    return pipeline.split_subintervals_shifted(ev, 2, 1)


def _stage_passes(mappers, events, trajs, fopts, passes: int, split=None,
                  stores: bool = False):
    """`passes` runs of run_full_seq (over `_Store`s of `events` where
    `stores`) whose process stages each camera's chunk, or each part of it
    that `split(chunk, camera)` gives, through a program's staging on the
    CPU (`Program._load`, pad "bucket"), checking the staged buffers
    against the host fill; the camera-chunks staged."""
    n_max = max(ev.time_window(t0, t1).num for ev in events
                for t0, t1, _ in pipeline.full_seq_windows(fopts))
    n_static = mapper.bucket_capacity(n_max, PACKET)
    body = mapper._setup(mappers[0], PACKET, "scatter", 8, "device")
    progs = [mapper.Program(("test", i), m, body, n_static, True, trj)
             for i, (m, trj) in enumerate(zip(mappers, trajs))]
    for prog in progs:
        prog.staging = _HostStaging(prog.events)
    T_rv_w = se3.identity(device="cpu")
    staged = [0]

    def process(mps, chunk, trs, ts):
        for cam, (prog, whole, trj) in enumerate(zip(progs, chunk, trs)):
            for ev in ([whole] if split is None else split(whole, cam)):
                prog._load(ev, trj, T_rv_w)
                staged[0] += 1
                host = [np.empty(n_static, np.int32), np.empty(n_static, np.int32),
                        np.empty(n_static, np.float32), np.empty(n_static, np.float32)]
                counted = dict(tracing.STAGED)
                mapper._stage(ev, *host)
                tracing.STAGED.update(counted)
                for want, got in zip(host, prog.events):
                    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                                  want.view(np.uint32))
        return ts

    for _ in range(passes):
        if stores:
            list(pipeline.run_full_seq_stores(mappers, [_Store(ev) for ev in events], trajs,
                                              fopts, process))
        else:
            list(pipeline.run_full_seq(mappers, events, trajs, fopts, process))
    return staged[0]


def _staged_since(before: dict) -> dict:
    return {k: tracing.STAGED[k] - before[k] for k in before}


def test_arrays_are_locked_once_across_passes_and_released_when_freed(fake):
    """Two passes of run_full_seq: each of the two cameras' x, y and t is
    locked once, over the pages that cover it, every camera-chunk is staged
    by DMA (none by the fill); the locks are released as the arrays are
    freed, and only then."""
    f = fake()
    mappers, events, trajs, fopts = _rig()
    before = dict(tracing.STAGED)
    chunks = _stage_passes(mappers, events, trajs, fopts, passes=2)
    assert chunks == 2 * 2 * 3
    assert len(f.registered) == 6
    page = graphs.mmap.PAGESIZE
    for (ptr, size), (start, nbytes) in zip(f.registered, [
            (a.ctypes.data, a.nbytes) for ev in events for a in (ev.x, ev.y, ev.t)]):
        assert ptr % page == 0 and size % page == 0
        assert ptr <= start and start + nbytes <= ptr + size < start + nbytes + page
    locked = sum(size for _, size in f.registered)
    staged = _staged_since(before)
    assert staged["dma_chunks"] == chunks and staged["fill_chunks"] == 0
    assert staged["registrations"] == 6 and staged["locked_bytes"] == locked
    assert f.released == []
    ptrs = [ptr for ptr, _ in f.registered]
    del events[0]
    gc.collect()
    assert sorted(f.released) == sorted(ptrs[:3])
    del events
    gc.collect()
    assert sorted(f.released) == sorted(ptrs)


@pytest.mark.parametrize("case", ["refused", "no_view"])
def test_arrays_not_locked_take_the_host_fill(fake, case):
    """A registration refused (asked once an array, across passes), and
    chunks that view no array of the run (fresh copies of its windows):
    every camera-chunk takes the host fill, to the same buffers."""
    f = fake(refuse=case == "refused")
    mappers, events, trajs, fopts = _rig()
    if case == "no_view":
        class Fresh(Events):
            def time_window(self, t0, t1):
                ev = Events.time_window(self, t0, t1)
                return Events(ev.x.copy(), ev.y.copy(), ev.t.copy())

        events = [Fresh(*ev) for ev in events]
    before = dict(tracing.STAGED)
    chunks = _stage_passes(mappers, events, trajs, fopts, passes=2)
    staged = _staged_since(before)
    assert staged["fill_chunks"] == chunks and staged["dma_chunks"] == 0
    # The run's streams are asked once each, across passes.
    assert len(f.registered) == 6
    assert staged["registrations"] == (0 if case == "refused" else 6)
    del events
    gc.collect()
    assert len(f.released) == (0 if case == "refused" else 6)


@pytest.mark.parametrize("case,split,stores,fills_a_window", [
    ("process_2", _process_2, False, 0),
    ("process_5", _process_5, False, 1),
    ("stores_process_1", None, True, 2),
    ("stores_process_2", _process_2, True, 4),
])
def test_sub_intervals_and_store_windows(fake, case, split, stores, fills_a_window):
    """Two passes of the sub-interval splits and of event stores:
    process_2's sub-intervals view the run's locked streams and go by DMA;
    of process_5's, the wrap-around concatenation (one a window) takes the
    fill; an event store's windows are fresh arrays: no array is locked,
    and every camera-chunk takes the fill."""
    f = fake()
    mappers, events, trajs, fopts = _rig()
    before = dict(tracing.STAGED)
    chunks = _stage_passes(mappers, events, trajs, fopts, passes=2, split=split,
                           stores=stores)
    windows = 2 * len(list(pipeline.full_seq_windows(fopts)))
    staged = _staged_since(before)
    assert staged["fill_chunks"] == fills_a_window * windows
    assert staged["dma_chunks"] == chunks - fills_a_window * windows
    assert len(f.registered) == staged["registrations"] == (0 if stores else 6)


def _hd_chunk(n: int, stream: int, rng) -> Events:
    """n events of a 1280x720 sensor over [0.3, 0.7] s, viewing a stream
    of `stream` events (at 9,000,000, arrays over glibc's largest mmap
    threshold of 32 MB, so that each lies on pages of its own, as a
    recording's streams do: an array that shares a page with one already
    locked is refused)."""
    t = np.sort(rng.uniform(0.3, 0.7, stream))
    return Events(rng.integers(0, 1280, stream).astype(np.int32),
                  rng.integers(0, 720, stream).astype(np.int32), t).slice(1000, 1000 + n)


@pytest.mark.card
def test_dma_and_fill_vote_the_same_dsi_on_the_card():
    """On the card, one chunk at a reduced HD size (1280x720, 16 planes,
    300,000 events off a bucket edge, packets of 1,024): the program's
    static buffers staged by DMA equal the host fill's to the bit, and the
    DSI voted from them has the same non-zero voxels as the fill's, apart
    by at most the order of the vote's atomic sums (relative L1 1e-6); the
    tracer counts 1 camera-chunk by DMA, none by the fill, and 3 arrays
    locked by `page_lock`.  A second array over memory already locked is
    refused: its chunk takes the fill, and the next kernel launch does not
    raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    rig = synthetic.esim_like_rig(travel=0.4)
    ts, q, p = synthetic.rig_poses(rig)
    traj = trajmod.from_arrays(ts, q, p, device=dev)
    cam = PinholeCamera(width=1280, height=720, fx=598.32, fy=598.32, cx=638.4, cy=373.1)
    m = make_mapper(cam, DsiShape(dim_z=16, min_depth=3.0, max_depth=100.0))
    T_rv_w = SE3(torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev),
                 torch.tensor([0.0, 0.0, 0.0], device=dev))
    n = 300_000
    ev = _hd_chunk(n, 9_000_000, np.random.default_rng(23))
    kw = dict(packet_size=1024, backend="scatter", pad="bucket")
    key = mapper.program_key(m, n, traj, 1024, "scatter", 8, "device", "bucket")

    def staged_buffers():
        return [b.cpu().numpy().view(np.uint32).copy() for b in mapper._PROGRAMS.get(key).events]

    # The fill: the same values in arrays that no one locked.
    fill_ev = Events(*(np.concatenate([a, a[:1]])[:-1] for a in ev[:3]))
    dsi_fill = mapper.evaluate_dsi(m, fill_ev, traj, T_rv_w, **kw)
    torch.cuda.synchronize(dev)
    fill_bufs = staged_buffers()

    tracing.enable(dev)
    mapper.page_lock([ev], dev)
    dsi_dma = mapper.evaluate_dsi(m, ev, traj, T_rv_w, **kw)
    torch.cuda.synchronize(dev)
    tracing.disable()
    staged = tracing.snapshot()["counters"]["staged"]
    assert staged["dma_chunks"] == 1 and staged["fill_chunks"] == 0
    assert staged["registrations"] == 3
    assert staged["events"] == n and staged["pad"] == mapper.bucket_capacity(n, 1024) - n
    for want, got in zip(fill_bufs, staged_buffers()):
        np.testing.assert_array_equal(got, want)
    assert torch.equal(dsi_dma != 0, dsi_fill != 0)
    l1 = float((dsi_dma.double() - dsi_fill.double()).abs().sum() / dsi_fill.double().sum())
    assert l1 <= 1e-6, l1

    # A second owner of memory already locked: refused, filled, no error left.
    owner = ev.x.base
    twin = np.frombuffer(owner.data, dtype=owner.dtype)
    assert twin.base is not owner and not isinstance(twin.base, np.ndarray)
    again = Events(twin[1000:1000 + n], ev.y, ev.t)
    tracing.enable(dev)
    mapper.page_lock([again], dev)
    dsi_again = mapper.evaluate_dsi(m, again, traj, T_rv_w, **kw)
    torch.ones(8, device=dev).add_(1)
    torch.cuda.synchronize(dev)
    tracing.disable()
    staged = tracing.snapshot()["counters"]["staged"]
    assert staged["fill_chunks"] == 1 and staged["dma_chunks"] == 0
    assert staged["registrations"] == 0
    assert torch.equal(dsi_again != 0, dsi_fill != 0)
